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
//   S   = F · Fo_chunkᵀ                      (mma, TF32 operands, f32 sums)
//   P   = f(X, S) elementwise in f32 registers, with the f32 kernels'
//         definitions: max(wh, eps), a zero ratio where X is 0 with no
//         division, IEEE division, powf, and logf over X > eps
//   acc += P · Fo_chunk                      (mma, TF32 operands, f32 sums)
// so the reconstruction WH is never written. Every operand of an mma (F, Fo
// and P) is rounded to TF32 by cvt.rna (to nearest, ties away from zero):
// mma on raw f32 bits would truncate the low mantissa. The plain twin
// (ops/mu_kernels.py: tf32_round, then the f32 kernels' plain terms) rounds
// the same values the same way; the two differ by the order of the f32
// sums and, rarely, by a TF32 rounding of P that flips where S differs in
// its last bit.
//
// The shape is that of flash attention with head width K. A block of 8
// warps owns 2 row groups of kRB = 4 restarts; warp w the row group w % 2
// of restart w / 2, MT 16-row tiles (2 up to K = 32, where the registers
// allow, else 1), so a block owns 32 MT rows. The contraction runs in
// chunks of kCC = 32 entries through a 2-slot cp.async ring: each chunk's
// X tile is staged once for the four restarts (16-byte copies along X's
// unit stride where its pitch and base allow, else 4-byte ones), each
// restart's Fo chunk once for its two row groups. Per chunk a warp runs
// K/8 x 4 x MT mma.sync.m16n8k8 for S, then, per 8 entries, K/8 x MT mma
// for each accumulator set (one for the KL numerator, two for the beta
// terms, none for the divergence term); each B fragment serves the MT
// tiles.
//
// Fragments (PTX m16n8k8 .tf32; g = lane / 4, t = lane % 4): A holds rows
// g, g+8 at columns t, t+4; B rows t, t+4 at column g; the accumulator rows
// g, g+8 at columns 2t, 2t+1. S's accumulator is not the second product's
// A layout, but the contraction may be relabelled within each 8 entries:
// the second product feeds S's column 2t as its k = t and column 2t+1 as its
// k = t+4, and reads Fo's rows in the same order, so P moves to the A
// fragment with no shuffle and no trip through shared memory.
//
// K: the register variant (KB = K / 8, 1..8) holds F's A fragments for the
// whole loop and stages Fo chunks in shared memory; above K = 64 the wide
// variant (KB = 0, MT = 1) reads F and Fo from device memory (L1 and L2)
// and splits the output columns into groups of 64, one per blockIdx.z,
// each computing S over all of K again. Padded rows, entries and restarts
// are zero-filled: they add nothing (a zero Fo row makes S 0, and its term
// is multiplied by that zero row) and are not stored.
//
// What bounds it on an H100: at the KL factorize shape (B=100, N=2700,
// G=2000, K=16) the two products are 4·B·N·G·K = 34.6 GFLOP, 0.07 ms at
// the 495 TFLOP/s of TF32. The tensor cores compute every entry, while the
// f32 kernels skip zero X entries, and the elementwise step (IEEE
// division, logf, cvt and shared-memory reads, about 16 instructions an
// entry) binds this design at K = 8 and 16: on one H100 it runs at the f32
// kernels' times (PERF.md). wgmma, TMA and skipping zero X chunks are later
// work.
//
// The divergence term writes one double partial per (block row tile,
// restart), part (ceil(M / mu_tf32_rows(K)), B); the wrapper sums them over
// row tiles in a fixed order (no atomics).

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
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

// 16-row tiles a warp owns: 2 while the A fragments and accumulators of
// both fit the registers (K <= 32), else 1
template <int KB>
constexpr int kMT = KB >= 1 && KB <= 4 ? 2 : 1;
// output rows a block owns
template <int KB>
constexpr int kTM = kGroups * 16 * kMT<KB>;
// the X tile's pitch read transposed (rows of kTM rows of X)
template <int KB>
constexpr int kXTP = kTM<KB> + 4;
// Fo's row pitch in shared memory: K + 4 floats puts both products' B
// fragment reads of a warp on 32 different banks.
template <int KB>
constexpr int kFoPitch = KB * 8 + 4;
// floats of one ring slot: the X tile and (register variant) the kRB Fo
// chunks; the ring's two slots in bytes
template <int KB>
constexpr int kSlotFloats =
    kTM<KB> * kXP + (KB > 0 ? kRB * kCC * kFoPitch<KB> : 0);
template <int KB>
constexpr int kSmemBytes = 2 * kSlotFloats<KB> * (int)sizeof(float);

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

// grid (ceil(B / kRB), ceil(M / kTM), output column groups: 1, or for the
// wide variant ceil(K / 64); 1 for the divergence term). out0 (and out1 for
// the beta terms' den) (B, M, K); part (gridDim.y, B) for the divergence.
template <int KB, int OP>
__global__ void __launch_bounds__(kThreadsTc)
tc_terms_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ Fo,
                const float* __restrict__ F, int B, int K, float beta,
                float* __restrict__ out0, float* __restrict__ out1,
                double* __restrict__ part) {
  constexpr bool kWide = KB == 0;
  constexpr int NO = kOuts<OP>;
  constexpr int MT = kMT<KB>;
  constexpr int TM = kTM<KB>, XTP = kXTP<KB>;
  constexpr int NI = kWide ? kWideTiles : KB;  // output n-tiles held
  constexpr int FP = kWide ? 0 : kFoPitch<KB>;
  constexpr int SLOT = kSlotFloats<KB>;
  static_assert(kCC * XTP <= TM * kXP, "the transposed tile fits");
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kGroups, rb = warp / kGroups;
  const int b0 = blockIdx.x * kRB, m0 = blockIdx.y * TM;
  const int b = b0 + rb;
  const bool live = b < B;  // the same for the whole warp
  const int kt = kWide ? K / 8 : KB;             // k-steps of S
  const int n0 = kWide ? blockIdx.z * NI : 0;    // first output n-tile
  const int ni = kWide ? min(NI, kt - n0) : NI;  // its live n-tiles
  // the warp's first row in the block; tile mt's rows are r0 + 16 mt + g
  // and + 8
  const int r0 = wr * 16 * MT;
  const float* const fo_b = Fo + (long long)b * C * K;

  // Chunk q into ring slot `slot`: the X tile as xs[m * kXP + c] = X(m0 +
  // m, q.kCC + c), or for X read transposed (xT: its unit stride along the
  // rows) as xs[c * XTP + m]; and (register variant) each restart's Fo
  // chunk fs[c * FP + k]; zero past M, C and B. X moves in 16-byte units
  // along its unit stride where its pitch is a multiple of 4 floats and it
  // is 16-byte aligned (vec), else in 4-byte ones.
  const bool xT = sxm == 1 && sxc != 1;
  const long long pitch = xT ? sxc : sxm;
  const bool vec = (xT || sxc == 1) && pitch % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(X) % 16 == 0;
  auto stage = [&](int slot, int q) {
    float* const xs = smem + slot * SLOT;
    const int c0 = q * kCC;
    if (vec) {
      // xT: units of 4 rows of one entry; else of 4 entries of one row
      const int inner = xT ? TM : kCC, outer = xT ? kCC : TM;
      const int lim_in = xT ? M - m0 : C - c0, lim_out = xT ? C - c0 : M - m0;
      for (int u = threadIdx.x; u < outer * inner / 4; u += kThreadsTc) {
        const int o = u / (inner / 4), i = u % (inner / 4) * 4;
        const int n = o < lim_out ? min(max(lim_in - i, 0), 4) : 0;
        const float* src =
            xT ? X + (c0 + o) * sxc + m0 + i : X + (m0 + o) * sxm + c0 + i;
        cnmf::cp_async16(xs + o * (xT ? XTP : kXP) + i, n > 0 ? src : X,
                         4 * n);
      }
    } else {
      for (int u = threadIdx.x; u < TM * kCC; u += kThreadsTc) {
        const int m = xT ? u % TM : u / kCC;
        const int c = xT ? u / TM : u % kCC;
        const bool ok = m0 + m < M && c0 + c < C;
        cnmf::cp_async4(xs + (xT ? c * XTP + m : m * kXP + c),
                        ok ? X + (m0 + m) * sxm + (c0 + c) * sxc : X,
                        ok ? 4 : 0);
      }
    }
    if constexpr (!kWide) {
      float* const fs = xs + TM * kXP;
      constexpr int U = kCC * KB * 2;  // 16-byte units of a restart's chunk
      for (int u = threadIdx.x; u < kRB * U; u += kThreadsTc) {
        const int r = u / U, c = u % U / (KB * 2), k4 = u % (KB * 2) * 4;
        const bool ok = b0 + r < B && c0 + c < C;
        cnmf::cp_async16(fs + (r * kCC + c) * FP + k4,
                         ok ? Fo + ((long long)(b0 + r) * C + c0 + c) * K + k4
                            : Fo,
                         ok ? 16 : 0);
      }
    }
  };

  const int nq = (C + kCC - 1) / kCC;
  stage(0, 0);
  cnmf::cp_async_commit();

  // S's A fragment of tile mt at k-step ks: rows r0 + 16 mt + g and + 8,
  // columns 8ks + t and 8ks + t + 4, zero past M and B.
  auto load_a = [&](uint32_t (&a)[4], int mt, int ks) {
    const int row = m0 + r0 + 16 * mt + g, k = 8 * ks + t;
    const float* const f = F + ((long long)b * M + row) * K + k;
    const bool lo = live && row < M, hi = live && row + 8 < M;
    a[0] = tf32(lo ? f[0] : 0.f);
    a[1] = tf32(hi ? f[8LL * K] : 0.f);
    a[2] = tf32(lo ? f[4] : 0.f);
    a[3] = tf32(hi ? f[8LL * K + 4] : 0.f);
  };
  uint32_t fa[MT][kWide ? 1 : KB][4];
  if constexpr (!kWide) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KB; ++ks) load_a(fa[mt][ks], mt, ks);
  }
  float acc[NO > 0 ? NO : 1][MT][NI][4];
#pragma unroll
  for (int o = 0; o < (NO > 0 ? NO : 1); ++o)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][mt][i][e] = 0.f;
  double sum = 0.0;

  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) stage((q + 1) & 1, q + 1);
    cnmf::cp_async_commit();
    cnmf::cp_async_wait<1>();
    __syncthreads();  // chunk q has landed for every thread
    const float* const xs = smem + (q & 1) * SLOT;
    const float* const fs = xs + TM * kXP + rb * kCC * FP;
    const int c0 = q * kCC;
    // Fo(c0 + c, k) of this warp's restart, as TF32
    auto fo = [&](int c, int k) -> uint32_t {
      if constexpr (kWide) {
        return tf32(c0 + c < C ? __ldg(fo_b + (long long)(c0 + c) * K + k)
                               : 0.f);
      } else {
        return tf32(fs[c * FP + k]);
      }
    };
    if (live) {
      float s[MT][kCC / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < kCC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
      // S = F_tile · Fo_chunkᵀ: column n of n-tile j is entry 8j + n; each
      // B fragment serves every tile of the warp
      auto s_step = [&](const uint32_t (&a)[MT][4], int kw) {
#pragma unroll
        for (int j = 0; j < kCC / 8; ++j) {
          const uint32_t bl = fo(8 * j + g, 8 * kw + t);
          const uint32_t bh = fo(8 * j + g, 8 * kw + t + 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(s[mt][j], a[mt], bl, bh);
        }
      };
      if constexpr (kWide) {
        for (int kw = 0; kw < kt; ++kw) {
          uint32_t a[MT][4];
          load_a(a[0], 0, kw);
          s_step(a, kw);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KB; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][e] = fa[mt][ks][e];
          s_step(a, ks);
        }
      }
#pragma unroll
      for (int j = 0; j < kCC / 8; ++j) {
        uint32_t pa[NO > 0 ? NO : 1][MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // X at S's accumulator entries: (row, 2t), (row, 2t+1), (row +
          // 8, 2t), (row + 8, 2t + 1) of n-tile j
          const int rr = r0 + 16 * mt + g;
          float x[4];
          if (xT) {
            const float* const xc = xs + (8 * j + 2 * t) * XTP + rr;
            x[0] = xc[0];
            x[1] = xc[XTP];
            x[2] = xc[8];
            x[3] = xc[XTP + 8];
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
                sum += (double)(x[e] * logf(fmaxf(s[mt][j][e], kEps)));
          } else {
            // P's A fragments: entry 2t is the product's k = t, 2t + 1 its
            // k = t + 4 (the relabelling above)
            float r[4], gg[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              terms<OP>(x[e], s[mt][j][e], beta, r[e], gg[e]);
            pa[0][mt][0] = tf32(r[0]);
            pa[0][mt][1] = tf32(r[2]);
            pa[0][mt][2] = tf32(r[1]);
            pa[0][mt][3] = tf32(r[3]);
            if constexpr (NO == 2) {
              pa[NO - 1][mt][0] = tf32(gg[0]);
              pa[NO - 1][mt][1] = tf32(gg[2]);
              pa[NO - 1][mt][2] = tf32(gg[1]);
              pa[NO - 1][mt][3] = tf32(gg[3]);
            }
          }
        }
        if constexpr (OP != kXLogWH) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (kWide && i >= ni) continue;
            const int col = 8 * (n0 + i) + g;
            const uint32_t bl = fo(8 * j + 2 * t, col);
            const uint32_t bh = fo(8 * j + 2 * t + 1, col);
#pragma unroll
            for (int o = 0; o < NO; ++o)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                mma_tf32(acc[o][mt][i], pa[o][mt], bl, bh);
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
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float* const out = o == 0 ? out0 : out1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = m0 + r0 + 16 * mt + g;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (kWide && i >= ni) continue;
          float* const dst = out + ((long long)b * M + row) * K + 8 * (n0 + i)
                             + 2 * t;
          if (row < M)
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[o][mt][i][0], acc[o][mt][i][1]);
          if (row + 8 < M)
            *reinterpret_cast<float2*>(dst + 8LL * K) =
                make_float2(acc[o][mt][i][2], acc[o][mt][i][3]);
        }
      }
    }
  }
}

// Lifts the kernel's dynamic shared memory limit to its ring's need (above
// the default 48 KB from K = 24 on), once per device; returns the CUDA
// error of that call, at every launch.
template <int KB, int OP>
int prepare() {
  constexpr int kDevices = 64;
  static std::atomic<int> done[kDevices];  // 0: not yet set, else error + 1
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int rc = done[dev].load(std::memory_order_acquire);
  if (rc == 0) {
    rc = 1 + (int)cudaFuncSetAttribute(
                 tc_terms_kernel<KB, OP>,
                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<KB>);
    done[dev].store(rc, std::memory_order_release);
  }
  return rc - 1;
}

template <int KB, int OP>
int launch_kb(const float* X, int M, int C, long long sxm, long long sxc,
              const float* Fo, const float* F, int B, int K, float beta,
              float* out0, float* out1, double* part, cudaStream_t stream) {
  if (const int rc = prepare<KB, OP>()) return rc;
  const int groups =
      KB > 0 || OP == kXLogWH ? 1 : (K / 8 + kWideTiles - 1) / kWideTiles;
  const dim3 grid((B + kRB - 1) / kRB, (M + kTM<KB> - 1) / kTM<KB>, groups);
  tc_terms_kernel<KB, OP><<<grid, kThreadsTc, kSmemBytes<KB>, stream>>>(
      X, M, C, sxm, sxc, Fo, F, B, K, beta, out0, out1, part);
  return (int)cudaGetLastError();
}

template <int OP>
int launch(const float* X, int M, int C, long long sxm, long long sxc,
           const float* Fo, const float* F, int B, int K, float beta,
           float* out0, float* out1, double* part, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || M < 1 || C < 1 || K < 8 || K % 8)
    return (int)cudaErrorInvalidValue;
#define TF32_CASE(KK)                                                       \
  case KK:                                                                  \
    return launch_kb<KK / 8, OP>(X, M, C, sxm, sxc, Fo, F, B, K, beta, out0, \
                                 out1, part, s);
  switch (K) { CNMF_K_BUCKETS(TF32_CASE) }
#undef TF32_CASE
  return launch_kb<0, OP>(X, M, C, sxm, sxc, Fo, F, B, K, beta, out0, out1,
                          part, s);
}

}  // namespace

extern "C" {

// out (B, M, K) = sum_c (X(m, c) / max(S, eps)) . F_other[c] with S = F[m]
// . F_other[c], both products in TF32; F (B, M, K), F_other (B, C, K).
int mu_kl_numerator_tf32(const float* X, int M, int C, long long sxm,
                         long long sxc, const float* F_other, const float* F,
                         int B, int K, float* out, void* stream) {
  return launch<kKL>(X, M, C, sxm, sxc, F_other, F, B, K, 0.f, out, nullptr,
                     nullptr, stream);
}

// num and den (B, M, K) of mu_beta_terms with both products in TF32; beta
// not in {1, 2} (0 is Itakura-Saito, its own build).
int mu_beta_terms_tf32(const float* X, int M, int C, long long sxm,
                       long long sxc, const float* F_other, const float* F,
                       int B, int K, float beta, float* num, float* den,
                       void* stream) {
  if (beta == 1.f || beta == 2.f) return (int)cudaErrorInvalidValue;
  return beta == 0.f
             ? launch<kIS>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num, den,
                           nullptr, stream)
             : launch<kPow>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num,
                            den, nullptr, stream);
}

// part (ceil(M / mu_tf32_rows(K)), B) = per row tile and restart, the sum
// over X(m, c) > eps of X(m, c) . logf(max(S, eps)), S in TF32, in double.
int mu_kl_x_log_wh_tf32(const float* X, int M, int C, long long sxm,
                        long long sxc, const float* F_other, const float* F,
                        int B, int K, double* part, void* stream) {
  return launch<kXLogWH>(X, M, C, sxm, sxc, F_other, F, B, K, 0.f, nullptr,
                         nullptr, part, stream);
}

// The output rows a block of these kernels owns at K (0 for a K they do
// not take).
int mu_tf32_rows(int K) {
  if (K < 8 || K % 8) return 0;
  switch (K) {
#define TF32_ROWS(KK) \
  case KK:            \
    return kTM<KK / 8>;
    CNMF_K_BUCKETS(TF32_ROWS)
#undef TF32_ROWS
  }
  return kTM<0>;
}

}  // extern "C"
