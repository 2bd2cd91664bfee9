// TF32 tensor-core multiplicative-update terms for Hopper (sm_90a), plain C
// ABI: the coarse phase of the MU precision ladder.
//
// Replaces no Pallas kernel. These are the card's counterpart of the JAX
// package's "default"-precision contractions, which its precision ladder's
// coarse phase runs on the XLA path (cnmf_tpu/ops/nmf.py:1092-1207 for the
// update terms, :1036 for the divergence; one-pass bf16 products on a TPU).
// Each entry point computes the function of one f32 kernel with both of its
// products on the tensor cores in TF32:
//   mu_kl_numerator_tf32  mu_kl.cu's numerator (pallas_mu.py:89, :394)
//   mu_beta_terms_tf32    mu_beta.cu's terms (pallas_mu.py:198, :281)
//   mu_kl_x_log_wh_tf32   mu_kl.cu's divergence term (pallas_mu.py:357)
// F (B, M, K) owns the output rows (W, or Ht with X read transposed through
// its strides), Fo (B, C, K) is contracted over, X(m, c) = X[m*sxm + c*sxc]:
//   S   = F · Fo_chunkᵀ                      (TF32 operands, f32 sums)
//   P   = f(X, S) elementwise in f32 registers
//   acc += P · Fo_chunk                      (TF32 operands, f32 sums)
// so the reconstruction WH is never written. Every operand of a product (F,
// Fo and P) is rounded to TF32 to nearest, ties away from zero: the tensor
// cores on raw f32 bits would truncate the low mantissa. The plain twin
// (ops/mu_kernels.py: tf32_round, then the f32 kernels' plain terms) rounds
// the same values the same way; the two differ by the order of the f32
// sums and, rarely, by a TF32 rounding of P that flips where S or the
// elementwise step differs in its last bits.
//
// Two designs. At K = 8..64 (the register buckets) all three run the
// Hopper design below (namespace hop): warpgroup wgmma products, the
// elementwise step in registers, a ring of TMA-fed slots, one X tile staged
// for a tile of R restarts. On one H100 80GB HBM3 at 700 W (chip_tune_cd.py
// --kernel tf32, PERF.md), at the KL factorize shape (B=100, N=2700,
// G=2000, K=16, the path's X) the KL numerator takes 0.366 ms W / 0.330 ms
// H a call, staging included, the beta 0 terms 0.427 / 0.462 and the beta
// 1.5 terms 0.653 / 0.772; the mma.sync design below took 1.188 / 1.250,
// 1.774 / 1.892 and 4.611 / 4.929 in the same run. What bounds them: the
// two products are 4·B·N·G·K = 34.6 GFLOP, 0.07 ms at 495 TFLOP/s; the
// elementwise step's reciprocal (or log and power) of each of the 5.4e8
// entries runs on the 16 special-function lanes an SM, 0.15 ms (0.3 ms for
// the general beta's two), beside about 6 other instructions an entry
// (0.11 ms of issue); at one block an SM, the KL numerator's 286 blocks of
// 128 rows x 8 restarts run in 3 rounds for 2.17 waves' work; the staging
// kernel adds about 0.02 ms. The divergence term (wg_xlogwh_kernel) needs
// only S: one wgmma product a restart, then the masked log of all 5.4e8
// entries in registers, X > eps or not (a warp's lanes hold different
// entries). It takes 0.4456 ms at that shape (K=8 0.3953; the mma.sync
// kernel 1.4166 / 1.0663 in the same run, the f32 kernel about 0.92 /
// 0.70); each entry's lg2.approx and conversion to double bound it (both
// run at 16 an SM a clock: 0.29 ms), not the product (0.035 ms). The wide
// variant (K > 64) of all three keeps the mma.sync design
// (tc_terms_kernel), its bits and its times.
//
// The mma.sync design (the wide variant): a block of 8 warps owns 2 row
// groups of 16 rows of kRB = 4 restarts, warp w the row group w % 2 of
// restart w / 2, and its output columns in groups of 64, one per
// blockIdx.z, each computing S over all of K again. The contraction runs in
// chunks of kCC = 32 entries through a 2-slot cp.async ring: each chunk's X
// tile is staged once for the four restarts (16-byte copies along X's unit
// stride where its pitch and base allow, else 4-byte ones); F and Fo are
// read from device memory (L1 and L2). Per chunk a warp runs mma.sync
// m16n8k8 for S and, per 8 entries, for each accumulator set. Fragments (PTX
// m16n8k8 .tf32; g = lane / 4, t = lane % 4): A holds rows g, g+8 at columns
// t, t+4; B rows t, t+4 at column g; the accumulator rows g, g+8 at columns
// 2t, 2t+1. S's accumulator is not the second product's A layout, but the
// contraction may be relabelled within each 8 entries: the second product
// feeds S's column 2t as its k = t and column 2t+1 as its k = t+4, and reads
// Fo's rows in the same order. Its elementwise step keeps the f32 kernels'
// definitions (max(wh, eps), a zero ratio where X is 0 with no division,
// IEEE division, powf, logf over X > eps). The divergence term, in both
// designs, writes one double partial per (block row tile, restart), part
// (ceil(M / mu_tf32_rows(K)), B); the wrapper sums them over row tiles in a
// fixed order (no atomics).

#include <cuda.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kWarps = 8;
constexpr int kThreadsTc = kWarps * 32;
constexpr int kGroups = 2;                 // row groups a block owns
constexpr int kRB = kWarps / kGroups;      // restarts a block owns
constexpr int kCC = 32;                    // contraction entries a chunk
constexpr int kXP = kCC + 8;               // X tile pitch, rows of entries
constexpr int kWideTiles = 8;              // output n-tiles a wide block owns

enum Op { kKL = 0, kIS = 1, kPow = 2, kXLogWH = 3 };

// accumulator sets of an op: the KL numerator, the beta terms' num and den,
// none for the divergence term
template <int OP>
constexpr int kOuts = OP == kKL ? 1 : OP == kXLogWH ? 0 : 2;

// output rows a block owns (two row groups of 16), the X tile's pitch read
// transposed (rows of kTM rows of X) and the floats of one ring slot
constexpr int kTM = kGroups * 16;
constexpr int kXTP = kTM + 4;
constexpr int kSlotFloats = kTM * kXP;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a · b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The elementwise factors of one entry: r = x . f(wh) (0 where x is 0, with
// no division) and, for the beta terms, g = g(wh); mu_kl.cu's and
// mu_beta.cu's definitions.
template <int OP>
__device__ __forceinline__ void terms(float x, float wh, float beta, float& r,
                                      float& g) {
  if (OP == kKL) {
    r = x == 0.f ? 0.f : x / fmaxf(wh, kEps);
  } else if (OP == kIS) {
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

// grid (ceil(B / kRB), ceil(M / kTM), output column groups: ceil(K / 64),
// 1 for the divergence term). out0 (and out1 for the beta terms' den) (B,
// M, K); part (gridDim.y, B) for the divergence.
template <int OP>
__global__ void __launch_bounds__(kThreadsTc)
tc_terms_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ Fo,
                const float* __restrict__ F, int B, int K, float beta,
                float* __restrict__ out0, float* __restrict__ out1,
                double* __restrict__ part) {
  constexpr int NO = kOuts<OP>;
  constexpr int NI = kWideTiles;  // output n-tiles held
  static_assert(kCC * kXTP <= kTM * kXP, "the transposed tile fits");
  __shared__ __align__(16) float smem[2 * kSlotFloats];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kGroups, rb = warp / kGroups;
  const int b0 = blockIdx.x * kRB, m0 = blockIdx.y * kTM;
  const int b = b0 + rb;
  const bool live = b < B;  // the same for the whole warp
  const int kt = K / 8;            // k-steps of S
  const int n0 = blockIdx.z * NI;  // first output n-tile
  const int ni = min(NI, kt - n0);  // its live n-tiles
  // the warp's first row in the block; its rows are r0 + g and + 8
  const int r0 = wr * 16;
  const float* const fo_b = Fo + (long long)b * C * K;

  // Chunk q's X tile into ring slot `slot`, as xs[m * kXP + c] = X(m0 + m,
  // q.kCC + c), or for X read transposed (xT: its unit stride along the
  // rows) as xs[c * kXTP + m]; zero past M and C. X moves in 16-byte units
  // along its unit stride where its pitch is a multiple of 4 floats and it
  // is 16-byte aligned (vec), else in 4-byte ones.
  const bool xT = sxm == 1 && sxc != 1;
  const long long pitch = xT ? sxc : sxm;
  const bool vec = (xT || sxc == 1) && pitch % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(X) % 16 == 0;
  auto stage = [&](int slot, int q) {
    float* const xs = smem + slot * kSlotFloats;
    const int c0 = q * kCC;
    if (vec) {
      // xT: units of 4 rows of one entry; else of 4 entries of one row
      const int inner = xT ? kTM : kCC, outer = xT ? kCC : kTM;
      const int lim_in = xT ? M - m0 : C - c0, lim_out = xT ? C - c0 : M - m0;
      for (int u = threadIdx.x; u < outer * inner / 4; u += kThreadsTc) {
        const int o = u / (inner / 4), i = u % (inner / 4) * 4;
        const int n = o < lim_out ? min(max(lim_in - i, 0), 4) : 0;
        const float* src =
            xT ? X + (c0 + o) * sxc + m0 + i : X + (m0 + o) * sxm + c0 + i;
        cnmf::cp_async16(xs + o * (xT ? kXTP : kXP) + i, n > 0 ? src : X,
                         4 * n);
      }
    } else {
      for (int u = threadIdx.x; u < kTM * kCC; u += kThreadsTc) {
        const int m = xT ? u % kTM : u / kCC;
        const int c = xT ? u / kTM : u % kCC;
        const bool ok = m0 + m < M && c0 + c < C;
        cnmf::cp_async4(xs + (xT ? c * kXTP + m : m * kXP + c),
                        ok ? X + (m0 + m) * sxm + (c0 + c) * sxc : X,
                        ok ? 4 : 0);
      }
    }
  };

  const int nq = (C + kCC - 1) / kCC;
  stage(0, 0);
  cnmf::cp_async_commit();

  // S's A fragment at k-step ks: rows r0 + g and + 8, columns 8ks + t and
  // 8ks + t + 4, zero past M and B.
  auto load_a = [&](uint32_t (&a)[4], int ks) {
    const int row = m0 + r0 + g, k = 8 * ks + t;
    const float* const f = F + ((long long)b * M + row) * K + k;
    const bool lo = live && row < M, hi = live && row + 8 < M;
    a[0] = tf32(lo ? f[0] : 0.f);
    a[1] = tf32(hi ? f[8LL * K] : 0.f);
    a[2] = tf32(lo ? f[4] : 0.f);
    a[3] = tf32(hi ? f[8LL * K + 4] : 0.f);
  };
  float acc[NO > 0 ? NO : 1][NI][4];
#pragma unroll
  for (int o = 0; o < (NO > 0 ? NO : 1); ++o)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][i][e] = 0.f;
  double sum = 0.0;

  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) stage((q + 1) & 1, q + 1);
    cnmf::cp_async_commit();
    cnmf::cp_async_wait<1>();
    __syncthreads();  // chunk q has landed for every thread
    const float* const xs = smem + (q & 1) * kSlotFloats;
    const int c0 = q * kCC;
    // Fo(c0 + c, k) of this warp's restart, as TF32
    auto fo = [&](int c, int k) -> uint32_t {
      return tf32(c0 + c < C ? __ldg(fo_b + (long long)(c0 + c) * K + k)
                             : 0.f);
    };
    if (live) {
      float s[kCC / 8][4];
#pragma unroll
      for (int j = 0; j < kCC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = F_tile · Fo_chunkᵀ: column n of n-tile j is entry 8j + n
      for (int kw = 0; kw < kt; ++kw) {
        uint32_t a[4];
        load_a(a, kw);
#pragma unroll
        for (int j = 0; j < kCC / 8; ++j) {
          const uint32_t bl = fo(8 * j + g, 8 * kw + t);
          const uint32_t bh = fo(8 * j + g, 8 * kw + t + 4);
          mma_tf32(s[j], a, bl, bh);
        }
      }
#pragma unroll
      for (int j = 0; j < kCC / 8; ++j) {
        uint32_t pa[NO > 0 ? NO : 1][4];
        // X at S's accumulator entries: (row, 2t), (row, 2t+1), (row + 8,
        // 2t), (row + 8, 2t + 1) of n-tile j
        const int rr = r0 + g;
        float x[4];
        if (xT) {
          const float* const xc = xs + (8 * j + 2 * t) * kXTP + rr;
          x[0] = xc[0];
          x[1] = xc[kXTP];
          x[2] = xc[8];
          x[3] = xc[kXTP + 8];
        } else {
          const float* const xr = xs + rr * kXP + 8 * j + 2 * t;
          const float2 xl = *reinterpret_cast<const float2*>(xr);
          const float2 xh = *reinterpret_cast<const float2*>(xr + 8 * kXP);
          x[0] = xl.x;
          x[1] = xl.y;
          x[2] = xh.x;
          x[3] = xh.y;
        }
        if constexpr (OP == kXLogWH) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (x[e] > kEps)
              sum += (double)(x[e] * logf(fmaxf(s[j][e], kEps)));
        } else {
          // P's A fragments: entry 2t is the product's k = t, 2t + 1 its
          // k = t + 4 (the relabelling above)
          float r[4], gg[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            terms<OP>(x[e], s[j][e], beta, r[e], gg[e]);
          pa[0][0] = tf32(r[0]);
          pa[0][1] = tf32(r[2]);
          pa[0][2] = tf32(r[1]);
          pa[0][3] = tf32(r[3]);
          if constexpr (NO == 2) {
            pa[NO - 1][0] = tf32(gg[0]);
            pa[NO - 1][1] = tf32(gg[2]);
            pa[NO - 1][2] = tf32(gg[1]);
            pa[NO - 1][3] = tf32(gg[3]);
          }
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (i >= ni) continue;
            const int col = 8 * (n0 + i) + g;
            const uint32_t bl = fo(8 * j + 2 * t, col);
            const uint32_t bh = fo(8 * j + 2 * t + 1, col);
#pragma unroll
            for (int o = 0; o < NO; ++o) mma_tf32(acc[o][i], pa[o], bl, bh);
          }
        }
      }
    }
    __syncthreads();  // slot q & 1 is consumed before chunk q + 2 lands in it
  }
  cnmf::cp_async_wait<0>();

  if constexpr (OP == kXLogWH) {
    __shared__ double red[kWarps];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, o);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    if (threadIdx.x < kRB && b0 + threadIdx.x < B) {
      double v = 0.0;
#pragma unroll
      for (int w = 0; w < kGroups; ++w) v += red[threadIdx.x * kGroups + w];
      part[(long long)blockIdx.y * B + b0 + threadIdx.x] = v;
    }
  } else {
    if (!live) return;
    const int row = m0 + r0 + g;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float* const out = o == 0 ? out0 : out1;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i >= ni) continue;
        float* const dst = out + ((long long)b * M + row) * K + 8 * (n0 + i)
                           + 2 * t;
        if (row < M)
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[o][i][0], acc[o][i][1]);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(dst + 8LL * K) =
              make_float2(acc[o][i][2], acc[o][i][3]);
      }
    }
  }
}

// ---- the Hopper design: all three at K = 8..64 ----
//
// A block owns kRows = 128 output rows of R restarts: two consumer
// warpgroups of 64 rows each and one producer warp. The contraction runs in
// chunks of kCC = 32 entries through a ring of kStages (3 or 4) slots; a
// slot holds the chunk's X tile (128 rows x 32 entries, staged once for the
// R restarts) and each restart's two TF32 copies of its Fo chunk, made by
// stage_kernel: the S product's B operand [K/4][kCC][4] and the second
// product's [kCC/4][K][4], the entries relabelled within each 8 as below.
// The producer's lane 0 waits for a slot to be free (mbarrier `empty`),
// then moves the Fo copies with one cp.async.bulk and X with TMA (a 2-D
// tensor map with the 128-byte swizzle, zero-filled past M and C); where
// X's pitch or base is not 16-byte aligned, or neither stride is 1, the
// producer's 32 lanes move X with 4-byte cp.async into the same swizzled
// places. Both complete on the slot's `full` mbarrier.
//
// A consumer warpgroup holds its R restarts' F tiles in shared memory
// ([K/4][64][4], TF32, staged once), and per chunk reads the 16 X values at
// its S positions into registers once for all R restarts. For restart r:
//   S   = F_tile · Fo_chunkᵀ   wgmma m64n32k8, both operands in shared memory
//   P   = f(X, S) in S's registers, rounded to TF32
//   acc += P · Fo_chunk        wgmma m64nKk8, A (P) from registers
// S of restart r + 1 is issued before P of restart r is computed, so the
// tensor cores run while the warpgroup computes; two register sets each of
// S, of P (and of the beta terms' den factor) keep every in-flight operand
// intact (wgmma.wait_group 1 leaves the previous restart's second product
// running). P is written straight into its A fragments' registers.
//
// TF32 wgmma takes K-major operands only (no transpose for .tf32): S's B
// operand is Fo's rows as stored, the second product's B needs Fo with the
// contraction contiguous, hence the second copy. The accumulator of S holds
// columns 2t and 2t + 1 of each 8 (t = lane % 4) where the A fragment wants
// k = t and t + 4; the second product feeds entry 2t as its k = t and 2t + 1
// as k = t + 4 (TF32_PERM in ops/mu_kernels.py), and its B copy holds Fo's
// entries in that order, so P needs no shuffle.
//
// The elementwise step, with w = max(S, eps) (S itself where the exponent
// is positive, as the f32 kernels floor it):
//   KL    x · rcp(w)                 (rcp.approx; zero where x is 0)
//   beta 0: d = rcp(w); x·d·d and d
//   beta: p = ex2((β−2)·lg2(w)), x·p and p·w = WH^(β−1) (for 1 < β < 2
//         and S < eps, where the den factor takes S unfloored, ex2((β−1)·
//         lg2(S)))
// and each factor is rounded to TF32 by adding half a TF32 ulp to its bits:
// the tensor cores drop the 13 low mantissa bits, so the sum rounds to
// nearest, ties away from zero, as cvt.rna does (the staged F and Fo are
// rounded by cvt.rna). A restart's arithmetic is the same in every slot of
// the restart tile and at every B; padded rows, entries and restarts read
// zeros and are not stored.
//
// The divergence term (wg_xlogwh_kernel) runs the same block, ring and X
// tile with one product and no staging kernel (its C entry point takes no
// scratch): a slot holds each restart's Fo chunk in S's operand layout
// alone. The producer moves each restart's rows of the chunk as Fo stores
// them with one bulk copy, a chunk ahead, then its 32 lanes round them to
// TF32 in place in that layout and arrive on `full` after a proxy fence
// (its synchronous loads from Fo had doubled the kernel's time). For
// restart r, S = F_tile · Fo_chunkᵀ (wgmma m64n32k8), S of r + 1 issued
// before the step of r; the step adds x · log(max(S, eps)) for x > eps
// into a double a restart, in a fixed order of entries (x read as zero
// where x <= eps: the product is then a zero that leaves the sum's bits as
// they were). Each thread's doubles are summed over its warp by shuffles,
// then over the 8 consumer warps in order: one partial a (128-row tile,
// restart), in the same order in every slot of the restart tile and at
// every B.
//
// The log is (x·ln 2)·lg2.approx(w), not the f32 kernels' logf: logf's 20
// or so FMA-pipe instructions an entry took the kernel to 1.14 ms at the
// factorize shape against 0.45, and on the card every restart stays within
// 1e-6 of its float64 plain version (2.5e-7 at most) and the precision
// ladder's KL arm keeps its sweeps (PERF.md, row T3). Measured and not kept:
// half the conversions to double by integer instructions instead of F2F
// (6 % faster here, 3-6 % slower on small grids), and a list of the
// entries with X > eps (27 % of the path's X) gathered once a chunk for the
// R restarts (slower: with two consumer warps an SM sub-partition the
// gathered loop waits on its loads).

namespace hop {

constexpr int kCC = 32;                   // contraction entries a chunk
constexpr int kWG = 2;                    // consumer warpgroups a block
constexpr int kRows = 64 * kWG;           // output rows a block owns
constexpr int kConsumers = 128 * kWG;     // their threads
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kXBytes = kRows * kCC * 4;  // a chunk's X tile
constexpr int kSmemLimit = 232448;        // a block's shared memory, H100
constexpr int kAlign = 1024;              // the 128-byte swizzle's atom
// how the producer moves X: TMA with X's rows along the output rows, TMA
// with X read transposed (its unit stride along the output rows), 4-byte
// cp.async
enum XMode { kXTma = 0, kXTmaT = 1, kXAsync = 2 };

// Restarts a block owns at K = 8·KB: the accumulators take R·K/2 registers
// a thread for the KL numerator (R·K <= 128) and R·K for the beta terms'
// two (R·K <= 64). At K = 8 and 16 the beta terms take fewer, as measured
// on an H100: with 8 and 4 restarts ptxas serializes their products for
// want of registers (C7512), with 6 and 3 (the general beta's 4 at K = 8)
// it does not, and they run 25-45 % faster.
// The divergence term holds no accumulator set, only a double a restart:
// its tile is what its shared memory allows (R Fo chunks a slot and R F
// tiles, a ring of at least 3 slots), 9 at K = 8 and 16, so that B = 100
// makes 12 restart tiles x 22 row tiles of N = 2700 = 264 blocks, two
// waves of the H100's 132 SMs at one block an SM (measured against 8, 10,
// and 4 at two blocks an SM: 32 %, 11 % and 4 % slower at K=16).
__host__ __device__ constexpr int restarts(int KB, int OP) {
  return OP == kXLogWH ? (KB <= 2 ? 9 : KB == 3 ? 8 : KB == 4 ? 6
                          : KB <= 6 ? 4 : 3)
         : OP == kKL ? 16 / KB
         : KB == 1 ? (OP == kIS ? 6 : 4)
         : KB == 2 ? 3
                   : (8 / KB > 1 ? 8 / KB : 1);
}

template <int KB, int OP>
struct Cfg {
  static constexpr int K = 8 * KB;
  static constexpr int R = restarts(KB, OP);
  // accumulator sets (the divergence term: none), and the Fo copies a
  // restart's chunk holds in a slot (S's operand, and the second product's)
  static constexpr int NO = OP == kKL ? 1 : OP == kXLogWH ? 0 : 2;
  static constexpr int kCopies = NO > 0 ? 2 : 1;
  static constexpr int kTile = kCopies * kCC * K * 4;  // a restart's chunk
  static constexpr int kFoBytes = R * kTile;
  static constexpr int kStage = kXBytes + kFoBytes;   // a ring slot
  static constexpr int kFBytes = R * kRows * K * 4;   // the F tiles
  // the mbarriers' 128 bytes (3 a slot at most), then the divergence term's
  // partials of its consumer warps
  static constexpr int kTail = 128 + (NO > 0 ? 0 : kWG * 4 * R * 8);
  static constexpr int kFit = (kSmemLimit - kAlign - kFBytes - kTail) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = kAlign + kStages * kStage + kFBytes + kTail;
  static_assert(kStages >= 3, "a ring of at least 3 slots fits");
  static_assert(kStage % kAlign == 0, "every slot starts on a swizzle atom");
};

__device__ __forceinline__ uint32_t tf32_operand(float p) {
  return __float_as_uint(p) + 0x1000u;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// ---- mbarriers, TMA and bulk copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   cnmf::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   cnmf::smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   cnmf::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(cnmf::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// the thread's earlier cp.async copies arrive on bar when they complete
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   cnmf::smem_addr(bar))
               : "memory");
}
// a box of the tensor map at (c0, c1) into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(cnmf::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(cnmf::smem_addr(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16) into dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(cnmf::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(cnmf::smem_addr(bar))
      : "memory");
}

// ---- wgmma ----

// The descriptor of a K-major operand with no swizzle: core matrices of 8
// rows of 16 bytes (128 contiguous bytes), `lbo` bytes from one to the next
// along the contraction, `sbo` bytes along the rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across this point
// (the registers of an in-flight wgmma)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= a · b, m64nNk8 with N = 2 x the registers of d: a's fragment in
// registers, b's descriptor in shared memory, d accumulated.
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[12],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[20],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[28],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Byte offset in a slot's X tile of X(m0 + m, c0 + c), as TMA's 128-byte
// swizzle places it: rows of 32 entries (128 bytes) whose 16-byte units are
// XORed with the row's index mod 8. xT: boxes of 32 output rows, each a
// row of 32 per entry.
__device__ __forceinline__ int x_offset(int m, int c, bool xT) {
  return xT ? (m >> 5) * (kCC * 128) + c * 128 +
                  ((((m & 31) >> 2) ^ (c & 7)) << 4) + ((m & 3) << 2)
            : m * 128 + (((c >> 2) ^ (m & 7)) << 4) + ((c & 3) << 2);
}

// staged (ceil(C / kCC), Bp, 2 kCC K): for chunk q and restart b, Fo's
// rows q·kCC .. + kCC as TF32, first as [K/4][kCC][4] (entry c, k at
// (k / 4)·4kCC + 4c + k % 4), then as [kCC/4][K][4] with the entries of each
// 8 in the order 0 2 4 6 1 3 5 7 (position p, k at (p / 4)·4K + 4k + p % 4);
// zero past C and B. grid (ceil(C / kCC)·Bp), 256 threads.
__global__ void __launch_bounds__(256)
stage_kernel(const float* __restrict__ Fo, int B, int C, int K, int Bp,
             float* __restrict__ staged) {
  const long long tile = blockIdx.x;
  const int b = (int)(tile % Bp), q = (int)(tile / Bp);
  const int n = kCC * K;
  float* const dst = staged + tile * 2 * n;
  for (int u = threadIdx.x; u < 2 * n; u += blockDim.x) {
    int c, k;
    if (u < n) {
      c = u % (4 * kCC) / 4;
      k = u / (4 * kCC) * 4 + u % 4;
    } else {
      const int v = u - n, p = v / (4 * K) * 4 + v % 4;
      k = v % (4 * K) / 4;
      c = (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
    }
    c += q * kCC;
    dst[u] = b < B && c < C
                 ? __uint_as_float(tf32(Fo[((long long)b * C + c) * K + k]))
                 : 0.f;
  }
}

// Where the second product's A fragment takes accumulator entry e: within
// each 4, entries (2t, 2t+1) of row g and of row g + 8 go to k = (t, t + 4)
// of those rows, fragment registers 0 2 1 3.
__host__ __device__ constexpr int frag_slot(int e) {
  return (e & ~3) | ((e & 1) << 1) | ((e >> 1) & 1);
}

// The elementwise factors of S's 16 entries as rounded TF32 operands, in the
// A fragments' order: p (and the beta terms' den factor g).
template <int OP>
__device__ __forceinline__ void terms(const float (&s)[16], uint32_t (&p)[16],
                                      uint32_t (&g)[16], const float (&x)[16],
                                      float beta) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int f = frag_slot(e);
    if (OP == kKL) {
      p[f] = tf32_operand(x[e] * rcp_approx(fmaxf(s[e], kEps)));
    } else if (OP == kIS) {
      const float d = rcp_approx(fmaxf(s[e], kEps));
      p[f] = tf32_operand(x[e] * d * d);
      g[f] = tf32_operand(d);
    } else {
      // WH^(β−1) = q·w, but for 1 < β < 2 the den factor takes S unfloored:
      // where S < eps, g keeps -S (its sign bit marks it) for the pass below
      const float w = beta < 2.f ? fmaxf(s[e], kEps) : s[e];
      const float q = ex2_approx((beta - 2.f) * lg2_approx(w));
      g[f] = beta >= 1.f && beta < 2.f && s[e] < kEps
                 ? __float_as_uint(-s[e])
                 : tf32_operand(q * w);
      p[f] = tf32_operand(x[e] * q);
    }
  }
  if (OP == kPow) {
    bool raw = false;
#pragma unroll
    for (int f = 0; f < 16; ++f) raw |= g[f] >> 31;
    if (__any_sync(0xffffffffu, raw)) {  // rare: zero rows of F or Fo
#pragma unroll
      for (int f = 0; f < 16; ++f)
        if (g[f] >> 31)
          g[f] = tf32_operand(ex2_approx(
              (beta - 1.f) * lg2_approx(-__uint_as_float(g[f]))));
    }
  }
}

// The start of a block of either kernel: its ring's mbarriers (`full`
// completing on `arrivals` arrivals, `empty` on one a consumer warp, and
// `loaded`, where given, on one) and the F tiles of restarts b0 .. b0 + R - 1
// as TF32, restart r's rows of warpgroup wg as [K/4][64][4], zero past M and
// B; then a block barrier.
template <int K, int R, int S>
__device__ __forceinline__ void block_start(uint64_t* full, uint64_t* empty,
                                            uint64_t* loaded, int arrivals,
                                            uint8_t* fsm,
                                            const float* __restrict__ F,
                                            int M, int B, int m0, int b0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], arrivals);
      mbar_init(&empty[s], kWG * 4);
      if (loaded) mbar_init(&loaded[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int u = threadIdx.x; u < R * kRows * (K / 4); u += kThreads) {
    const int k4 = u % (K / 4), row = u / (K / 4) % kRows;
    const int r = u / (K / 4 * kRows);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + r < B && m0 + row < M)
      v = *reinterpret_cast<const float4*>(
          F + ((long long)(b0 + r) * M + m0 + row) * K + 4 * k4);
    *reinterpret_cast<uint4*>(
        fsm + ((r * kWG + row / 64) * 64 * K + k4 * 256 + row % 64 * 4) * 4) =
        make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
  }
  // the tiles, written by threads, are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Chunk q's X tile into the slot at st, from the producer warp's lane
// `lane`: by TMA from lane 0 (its bytes expected on bar by the caller), or
// by 4-byte cp.async from every lane into the same swizzled places, each
// lane's copies arriving on bar (uncounted: in bar's arrivals) as they land.
__device__ __forceinline__ void load_x(uint8_t* st, const CUtensorMap* xmap,
                                       int xmode, bool xT,
                                       const float* __restrict__ X, int M,
                                       int C, long long sxm, long long sxc,
                                       int m0, int q, int lane,
                                       uint64_t* bar) {
  if (xmode == kXTma) {
    if (lane == 0) tma_load(st, xmap, q * kCC, m0, bar);
  } else if (xmode == kXTmaT) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows / 32; ++i)
        tma_load(st + i * kCC * 128, xmap, m0 + 32 * i, q * kCC, bar);
    }
  } else {
    const int c0 = q * kCC;
    for (int e = lane; e < kRows * kCC; e += 32) {
      const int m = xT ? e % kRows : e / kCC, c = xT ? e / kRows : e % kCC;
      const bool ok = m0 + m < M && c0 + c < C;
      cnmf::cp_async4(reinterpret_cast<float*>(st + x_offset(m, c, xT)),
                      ok ? X + (m0 + m) * sxm + (c0 + c) * sxc : X,
                      ok ? 4 : 0);
    }
    cp_async_arrive(bar);
  }
}

// X at a consumer thread's 16 S positions in the slot at st: accumulator
// entry 4i + 2h + e is (row mr + 8h, entry 8i + 2t + e).
__device__ __forceinline__ void read_x(float (&xv)[16], const uint8_t* st,
                                       int mr, int t, bool xT) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mr + 8 * h, c = 8 * i + 2 * t;
      if (xT) {
        xv[4 * i + 2 * h] =
            *reinterpret_cast<const float*>(st + x_offset(m, c, true));
        xv[4 * i + 2 * h + 1] =
            *reinterpret_cast<const float*>(st + x_offset(m, c + 1, true));
      } else {
        const float2 v =
            *reinterpret_cast<const float2*>(st + x_offset(m, c, false));
        xv[4 * i + 2 * h] = v.x;
        xv[4 * i + 2 * h + 1] = v.y;
      }
    }
}

// grid (ceil(M / kRows), Bp / R), kThreads threads, Cfg::kSmem bytes.
// out0 (and out1, the beta terms' den) (B, M, K); staged from stage_kernel
// with Bp = ceil(B / R)·R.
template <int KB, int OP>
__global__ void __launch_bounds__(kThreads, 1)
wg_terms_kernel(const __grid_constant__ CUtensorMap xmap, int xmode, int xT,
                const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ staged,
                const float* __restrict__ F, int B, int Bp, float beta,
                float* __restrict__ out0, float* __restrict__ out1) {
  using G = Cfg<KB, OP>;
  constexpr int K = G::K, R = G::R, NO = G::NO, S = G::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((kAlign - cnmf::smem_addr(smem_raw) % kAlign) % kAlign);
  uint8_t* const fsm = smem + S * G::kStage;
  uint64_t* const full = reinterpret_cast<uint64_t*>(fsm + G::kFBytes);
  uint64_t* const empty = full + S;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kRows, b0 = blockIdx.y * R;
  const int nq = (C + kCC - 1) / kCC;

  block_start<K, R, S>(full, empty, nullptr, xmode == kXAsync ? 33 : 1, fsm,
                       F, M, B, m0, b0);

  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    if (xmode != kXAsync && lane != 0) return;
    for (int q = 0; q < nq; ++q) {
      const int s = q % S;
      if (q >= S) mbar_wait(&empty[s], (q / S - 1) & 1);
      uint8_t* const st = smem + s * G::kStage;
      if (lane == 0) {
        mbar_expect_tx(&full[s],
                       G::kFoBytes + (xmode == kXAsync ? 0 : kXBytes));
        bulk_load(st + kXBytes, staged + ((long long)q * Bp + b0) * (2 * kCC * K),
                  G::kFoBytes, &full[s]);
      }
      load_x(st, &xmap, xmode, xT, X, M, C, sxm, sxc, m0, q, lane, &full[s]);
    }
    return;
  }

  // a consumer: warpgroup wg (read through a shuffle, so the compiler
  // holds what derives from it, the descriptors, as uniform across the
  // warp), its warp's rows 16 warp + g and + 8
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mr = 64 * wg + 16 * warp + g;
  // the operands' descriptors: the warpgroup's F tile of restart 0, and the
  // two Fo copies of restart 0 in slot 0 (a slot, restart and k-step add
  // their offset in 16-byte units)
  const uint64_t f_desc =
      desc(cnmf::smem_addr(fsm) + wg * 64 * K * 4, 64 * 16, 128);
  const uint32_t fo0 = cnmf::smem_addr(smem) + kXBytes;
  const uint64_t s_desc = desc(fo0, kCC * 16, 128);
  const uint64_t t_desc = desc(fo0 + kCC * K * 4, K * 16, 128);
  float acc[NO][R][K / 2];
  constexpr int NG = NO == 2 ? 2 : 1;
  float sv[2][16];      // S of restart r, and of r + 1 in flight
  uint32_t pv[2][16];   // P's A fragments of the two restarts whose second
  uint32_t gv[NG][16];  // products may run (wait_group 1), the den's too
  float xv[16];         // X at S's entries
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < K / 2; ++i) acc[o][r][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sv[0][i] = sv[1][i] = 0.f;
    pv[0][i] = pv[1][i] = gv[0][i] = gv[NG - 1][i] = 0u;
  }

  for (int q = 0; q < nq; ++q) {
    const int s = q % S;
    mbar_wait(&full[s], (q / S) & 1);
    __syncwarp();  // the warp leaves the wait together: wgmma is .aligned
    const uint8_t* const st = smem + s * G::kStage;
    read_x(xv, st, mr, t, xT);
    const uint64_t slot = (uint64_t)(s * G::kStage) >> 4;
    // S of restart r into d: k-step ks takes F's k groups 2ks, 2ks + 1
    auto issue_s = [&](float (&d)[16], int r) {
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KB; ++ks)
        wgmma_ss(d, f_desc + ((r * kWG * 64 * K * 4 + ks * 2 * 64 * 16) >> 4),
                 s_desc + slot + ((r * G::kTile + ks * 2 * kCC * 16) >> 4),
                 ks > 0);
      wgmma_commit();
    };
    // acc[o][r] += P · Fo_chunk, P's fragments p: step j takes entries 8j
    // .. 8j + 7, the copy's position groups 2j, 2j + 1
    auto issue_p = [&](float (&a)[K / 2], const uint32_t (&p)[16], int r) {
#pragma unroll
      for (int j = 0; j < kCC / 8; ++j)
        wgmma_rs(a, *reinterpret_cast<const uint32_t(*)[4]>(p + 4 * j),
                 t_desc + slot + ((r * G::kTile + j * 2 * K * 16) >> 4));
    };
    issue_s(sv[0], 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r == 0)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();  // S of r is done; the product of r - 1 may run on
      // (the fences keep what the product of r - 2 read in its registers
      // until it is done)
      reg_fence(sv[r % 2]);
      reg_fence(pv[r % 2]);
      if constexpr (NO == 2) reg_fence(gv[r % 2]);
      if (r + 1 < R) issue_s(sv[(r + 1) % 2], r + 1);
      terms<OP>(sv[r % 2], pv[r % 2], gv[r % NG], xv, beta);
      wgmma_fence();
      issue_p(acc[0][r], pv[r % 2], r);
      if constexpr (NO == 2) issue_p(acc[NO - 1][r], gv[r % 2], r);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(pv[0]);
    reg_fence(pv[1]);
    if constexpr (NO == 2) {
      reg_fence(gv[0]);
      reg_fence(gv[1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int o = 0; o < NO; ++o) {
    float* const out = o == 0 ? out0 : out1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      reg_fence(acc[o][r]);
      if (b0 + r >= B) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mr + 8 * h;
        if (row >= M) continue;
        float* const dst = out + ((long long)(b0 + r) * M + row) * K + 2 * t;
#pragma unroll
        for (int i = 0; i < KB; ++i)
          *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(
              acc[o][r][4 * i + 2 * h], acc[o][r][4 * i + 2 * h + 1]);
      }
    }
  }
}

// grid (ceil(M / kRows), ceil(B / R)), kThreads threads, Cfg::kSmem bytes.
// part (gridDim.x, B): per row tile and restart, the sum over X > eps of
// X · logf(max(S, eps)) in double.
template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
wg_xlogwh_kernel(const __grid_constant__ CUtensorMap xmap, int xmode, int xT,
                 const float* __restrict__ X, int M, int C, long long sxm,
                 long long sxc, const float* __restrict__ Fo,
                 const float* __restrict__ F, int B,
                 double* __restrict__ part) {
  using G = Cfg<KB, kXLogWH>;
  constexpr int K = G::K, R = G::R, S = G::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((kAlign - cnmf::smem_addr(smem_raw) % kAlign) % kAlign);
  uint8_t* const fsm = smem + S * G::kStage;
  uint64_t* const full = reinterpret_cast<uint64_t*>(fsm + G::kFBytes);
  uint64_t* const empty = full + S;
  double* const red = reinterpret_cast<double*>(fsm + G::kFBytes + 128);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kRows, b0 = blockIdx.y * R;
  const int nq = (C + kCC - 1) / kCC;

  // a slot is full on its X (one arrival with its bytes, or one a lane's
  // cp.async) and on each producer lane's Fo writes; `loaded` on its Fo
  // rows as Fo stores them
  uint64_t* const loaded = empty + S;
  block_start<K, R, S>(full, empty, loaded, xmode == kXAsync ? 64 : 33, fsm,
                       F, M, B, m0, b0);

  if (tid >= kConsumers) {  // the producer warp
    const int lane = tid - kConsumers;
    // chunk q into slot q % S once it is free: X (on `full`) and each live
    // restart's kCC rows of Fo, one bulk copy a restart (on `loaded`)
    auto load = [&](int q) {
      const int s = q % S;
      if (q >= S) mbar_wait(&empty[s], (q / S - 1) & 1);
      uint8_t* const st = smem + s * G::kStage;
      if (lane == 0) {
        const int c0 = q * kCC, rows = min(kCC, C - c0), live = min(R, B - b0);
        mbar_expect_tx(&loaded[s], live * rows * K * 4);
        for (int r = 0; r < live; ++r)
          bulk_load(st + kXBytes + r * G::kTile,
                    Fo + ((long long)(b0 + r) * C + c0) * K, rows * K * 4,
                    &loaded[s]);
        if (xmode != kXAsync) mbar_expect_tx(&full[s], kXBytes);
      }
      load_x(st, &xmap, xmode, xT, X, M, C, sxm, sxc, m0, q, lane, &full[s]);
    };
    load(0);
    for (int q = 0; q < nq; ++q) {
      if (q + 1 < nq) load(q + 1);  // in flight while chunk q is rounded
      const int s = q % S;
      mbar_wait(&loaded[s], (q / S) & 1);
      // each restart's rows [kCC][K] in place as TF32 in S's operand layout
      // [K/4][kCC][4], zero past C and B: lane c moves entry c. The rounding
      // is cvt.rna's on finite values (to nearest, ties away from zero, a
      // carry moving into the exponent), as stage_kernel rounds.
      uint4* const tiles =
          reinterpret_cast<uint4*>(smem + s * G::kStage + kXBytes);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        uint4* const tile = tiles + r * (G::kTile / 16);
        const bool live = b0 + r < B && q * kCC + lane < C;
        uint4 v[K / 4];
#pragma unroll
        for (int i = 0; i < K / 4; ++i) v[i] = tile[lane * (K / 4) + i];
        __syncwarp();
#pragma unroll
        for (int i = 0; i < K / 4; ++i)
          tile[i * kCC + lane] =
              live ? make_uint4((v[i].x + 0x1000u) & 0xffffe000u,
                                (v[i].y + 0x1000u) & 0xffffe000u,
                                (v[i].z + 0x1000u) & 0xffffe000u,
                                (v[i].w + 0x1000u) & 0xffffe000u)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      // the writes, made by threads, are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer, as in wg_terms_kernel
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int t = lane & 3;
  const int mr = 64 * wg + 16 * warp + (lane >> 2);
  const uint64_t f_desc =
      desc(cnmf::smem_addr(fsm) + wg * 64 * K * 4, 64 * 16, 128);
  const uint64_t s_desc = desc(cnmf::smem_addr(smem) + kXBytes, kCC * 16, 128);
  double acc[R];
  float sv[2][16];  // S of restart r, and of r + 1 in flight
  float xv[16];     // X·ln 2 at S's entries, 0 where X <= eps
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0;
#pragma unroll
  for (int i = 0; i < 16; ++i) sv[0][i] = sv[1][i] = 0.f;

  for (int q = 0; q < nq; ++q) {
    const int s = q % S;
    mbar_wait(&full[s], (q / S) & 1);
    __syncwarp();  // the warp leaves the wait together: wgmma is .aligned
    read_x(xv, smem + s * G::kStage, mr, t, xT);
#pragma unroll
    for (int e = 0; e < 16; ++e) xv[e] = xv[e] > kEps ? xv[e] * kLn2 : 0.f;
    const uint64_t slot = (uint64_t)(s * G::kStage) >> 4;
    // S of restart r into d: k-step ks takes F's k groups 2ks, 2ks + 1
    auto issue_s = [&](float (&d)[16], int r) {
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KB; ++ks)
        wgmma_ss(d, f_desc + ((r * kWG * 64 * K * 4 + ks * 2 * 64 * 16) >> 4),
                 s_desc + slot + ((r * G::kTile + ks * 2 * kCC * 16) >> 4),
                 ks > 0);
      wgmma_commit();
    };
    issue_s(sv[0], 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wgmma_wait<0>();  // S of r is done
      reg_fence(sv[r % 2]);
      if (r + 1 < R) issue_s(sv[(r + 1) % 2], r + 1);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[r] += (double)(xv[e] * lg2_approx(fmaxf(sv[r % 2][e], kEps)));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // each restart's sum over the warp (a fixed shuffle tree), then over the
  // consumer warps in order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    double v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[(tid >> 5) * R + r] = v;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  if (tid < R && b0 + tid < B) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kWG * 4; ++w) v += red[w * R + tid];
    part[(long long)blockIdx.x * B + b0 + tid] = v;
  }
}

}  // namespace hop

// Lifts a kernel's dynamic shared memory limit to `bytes` once per device
// (done: one slot per device, 0 not yet set, else the error + 1); returns
// the CUDA error of that call, at every launch.
constexpr int kDevices = 64;
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, std::atomic<int>* done) {
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int rc = done[dev].load(std::memory_order_acquire);
  if (rc == 0) {
    rc = 1 + (int)cudaFuncSetAttribute(
                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done[dev].store(rc, std::memory_order_release);
  }
  return rc - 1;
}

template <int OP>
int launch_wide(const float* X, int M, int C, long long sxm, long long sxc,
                const float* Fo, const float* F, int B, int K, float beta,
                float* out0, float* out1, double* part, cudaStream_t stream) {
  const int groups =
      OP == kXLogWH ? 1 : (K / 8 + kWideTiles - 1) / kWideTiles;
  const dim3 grid((B + kRB - 1) / kRB, (M + kTM - 1) / kTM, groups);
  tc_terms_kernel<OP><<<grid, kThreadsTc, 0, stream>>>(
      X, M, C, sxm, sxc, Fo, F, B, K, beta, out0, out1, part);
  return (int)cudaGetLastError();
}

namespace hop {

// cuTensorMapEncodeTiled, reached through the runtime (the library links no
// libcuda); null where the driver does not give it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// How the producer moves X (an XMode), and *xT whether X is read transposed;
// for TMA, *map describes X as 2-D along its unit stride with the slot's
// boxes (32 entries x kRows rows, or 32 rows x kCC entries read transposed)
// and the 128-byte swizzle.
int x_mode(CUtensorMap* map, const float* X, int M, int C, long long sxm,
           long long sxc, int* xT) {
  *xT = sxm == 1 && sxc != 1;
  const long long pitch = *xT ? sxc : sxm;
  if (!(*xT || sxc == 1) || pitch % 4 ||
      reinterpret_cast<uintptr_t>(X) % 16)
    return kXAsync;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kXAsync;
  const cuuint64_t dims[2] = {(cuuint64_t)(*xT ? M : C),
                              (cuuint64_t)(*xT ? C : M)};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)(*xT ? kCC : kRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(X), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? (*xT ? kXTmaT : kXTma) : kXAsync;
}

int stage(const float* Fo, int B, int C, int K, int Bp, float* staged,
          cudaStream_t stream) {
  const long long tiles = (long long)((C + kCC - 1) / kCC) * Bp;
  stage_kernel<<<(unsigned)tiles, 256, 0, stream>>>(Fo, B, C, K, Bp, staged);
  return (int)cudaGetLastError();
}

// stage_kernel's copies of Fo into staged, then wg_terms_kernel
template <int KB, int OP>
int launch(const float* X, int M, int C, long long sxm, long long sxc,
           const float* Fo, const float* F, int B, float beta, float* staged,
           float* out0, float* out1, cudaStream_t stream) {
  using G = Cfg<KB, OP>;
  static std::atomic<int> done[kDevices];
  if (staged == nullptr) return (int)cudaErrorInvalidValue;
  if (const int rc = allow_smem(wg_terms_kernel<KB, OP>, G::kSmem, done))
    return rc;
  const int Bp = (B + G::R - 1) / G::R * G::R;
  if (const int rc = stage(Fo, B, C, G::K, Bp, staged, stream)) return rc;
  CUtensorMap map{};
  int xT = 0;
  const int xmode = x_mode(&map, X, M, C, sxm, sxc, &xT);
  const dim3 grid((M + kRows - 1) / kRows, Bp / G::R);
  wg_terms_kernel<KB, OP><<<grid, kThreads, G::kSmem, stream>>>(
      map, xmode, xT, X, M, C, sxm, sxc, staged, F, B, Bp, beta, out0, out1);
  return (int)cudaGetLastError();
}

// wg_xlogwh_kernel into part (ceil(M / kRows), B)
template <int KB>
int launch_xlogwh(const float* X, int M, int C, long long sxm, long long sxc,
                  const float* Fo, const float* F, int B, double* part,
                  cudaStream_t stream) {
  using G = Cfg<KB, kXLogWH>;
  static std::atomic<int> done[kDevices];
  if (const int rc = allow_smem(wg_xlogwh_kernel<KB>, G::kSmem, done))
    return rc;
  CUtensorMap map{};
  int xT = 0;
  const int xmode = x_mode(&map, X, M, C, sxm, sxc, &xT);
  const dim3 grid((M + kRows - 1) / kRows, (B + G::R - 1) / G::R);
  wg_xlogwh_kernel<KB><<<grid, kThreads, G::kSmem, stream>>>(
      map, xmode, xT, X, M, C, sxm, sxc, Fo, F, B, part);
  return (int)cudaGetLastError();
}

}  // namespace hop

// K = 8..64 runs the Hopper kernels, a wide K the mma.sync one.
template <int OP>
int launch(const float* X, int M, int C, long long sxm, long long sxc,
           const float* Fo, const float* F, int B, int K, float beta,
           float* staged, float* out0, float* out1, double* part,
           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || M < 1 || C < 1 || K < 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  if constexpr (OP == kXLogWH) {
#define XLW_CASE(KK)                                                      \
  case KK:                                                                \
    return hop::launch_xlogwh<KK / 8>(X, M, C, sxm, sxc, Fo, F, B, part, s);
    switch (K) { CNMF_K_BUCKETS(XLW_CASE) }
#undef XLW_CASE
  } else {
#define HOP_CASE(KK)                                                       \
  case KK:                                                                 \
    return hop::launch<KK / 8, OP>(X, M, C, sxm, sxc, Fo, F, B, beta,      \
                                   staged, out0, out1, s);
    switch (K) { CNMF_K_BUCKETS(HOP_CASE) }
#undef HOP_CASE
  }
  return launch_wide<OP>(X, M, C, sxm, sxc, Fo, F, B, K, beta, out0, out1,
                         part, s);
}

}  // namespace

extern "C" {

// out (B, M, K) = sum_c (X(m, c) / max(S, eps)) . F_other[c] with S = F[m]
// . F_other[c], both products in TF32; F (B, M, K), F_other (B, C, K).
// staged: scratch for mu_tf32_stage's copies of F_other at K = 8..64 (null
// at a wide K).
int mu_kl_numerator_tf32(const float* X, int M, int C, long long sxm,
                         long long sxc, const float* F_other, const float* F,
                         int B, int K, float* staged, float* out,
                         void* stream) {
  return launch<kKL>(X, M, C, sxm, sxc, F_other, F, B, K, 0.f, staged, out,
                     nullptr, nullptr, stream);
}

// num and den (B, M, K) of mu_beta_terms with both products in TF32; beta
// not in {1, 2} (0 is Itakura-Saito, its own build); staged as
// mu_kl_numerator_tf32 takes it.
int mu_beta_terms_tf32(const float* X, int M, int C, long long sxm,
                       long long sxc, const float* F_other, const float* F,
                       int B, int K, float beta, float* staged, float* num,
                       float* den, void* stream) {
  if (beta == 1.f || beta == 2.f) return (int)cudaErrorInvalidValue;
  return beta == 0.f
             ? launch<kIS>(X, M, C, sxm, sxc, F_other, F, B, K, beta, staged,
                           num, den, nullptr, stream)
             : launch<kPow>(X, M, C, sxm, sxc, F_other, F, B, K, beta, staged,
                            num, den, nullptr, stream);
}

// part (ceil(M / mu_tf32_rows(K)), B) = per row tile and restart, the sum
// over X(m, c) > eps of X(m, c) . logf(max(S, eps)), S in TF32, in double.
int mu_kl_x_log_wh_tf32(const float* X, int M, int C, long long sxm,
                        long long sxc, const float* F_other, const float* F,
                        int B, int K, double* part, void* stream) {
  return launch<kXLogWH>(X, M, C, sxm, sxc, F_other, F, B, K, 0.f, nullptr,
                         nullptr, nullptr, part, stream);
}

// The output rows a block of the divergence term owns at K (0 for a K it
// does not take).
int mu_tf32_rows(int K) {
  if (K < 8 || K % 8) return 0;
  return K <= cnmf::kRegMaxK ? hop::kRows : kTM;
}

// The restarts a block of the KL numerator (op 0), the beta terms at beta 0
// (1) or at another beta (2), or the divergence term (3) owns at K; 0 at a
// K that runs the wide variant.
int mu_tf32_restarts(int K, int op) {
  if (K < 8 || K % 8 || K > cnmf::kRegMaxK || op < 0 || op > 3) return 0;
  return hop::restarts(K / 8, op == 0 ? kKL : op == 1 ? kIS
                              : op == 2 ? kPow : kXLogWH);
}

// The contraction entries of a staged chunk.
int mu_tf32_chunk() { return hop::kCC; }

// The staged copies of F_other (B, C, K) for Bp restarts (B rounded up to a
// multiple of mu_tf32_restarts): (ceil(C / mu_tf32_chunk()), Bp, 2 chunk K)
// floats, as ops/mu_kernels.tf32_stage_plain lays them out.
int mu_tf32_stage(const float* F_other, int B, int C, int K, int Bp,
                  float* staged, void* stream) {
  if (B < 1 || C < 1 || K < 8 || K % 8 || Bp < B)
    return (int)cudaErrorInvalidValue;
  return hop::stage(F_other, B, C, K, Bp, staged, (cudaStream_t)stream);
}

// How a launch moves X of these strides and base (hop::XMode: 0 and 1 TMA,
// 2 four-byte cp.async).
int mu_tf32_x_mode(const float* X, int M, int C, long long sxm,
                   long long sxc) {
  CUtensorMap map{};
  int xT = 0;
  return hop::x_mode(&map, X, M, C, sxm, sxc, &xT);
}

}  // extern "C"
