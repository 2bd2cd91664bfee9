// Fused general-beta multiplicative-update terms for Hopper (sm_90a), plain
// C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_mu.py:
//   beta_mu_w_terms (:198, body _make_beta_w_terms_kernel :173) -> W side
//   beta_mu_h_terms (:281, body _make_beta_h_terms_kernel :239) -> H side
// for beta not in {1, 2} (0 is Itakura-Saito). One kernel serves both sides,
// on the design of mu_kl.cu: one block owns one 128-row tile of one restart of
// the factor F whose rows index the output (W, or Ht with X read transposed),
// loops over the whole contraction axis staging chunks of X and of the other
// factor Fo in shared memory, and each thread owns one row. For each staged
// entry c it computes
//   wh   = F[m] . Fo[c]                              (K FMAs)
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
// What bounds it on an H100: the f32 pipe. Per staged element and restart
// it spends 3K FMAs plus one reciprocal (beta = 0) or two powf; at the
// factorize shape (B=100, N=2700, G=2000, K=16) that is 6.N.G.K.B = 51.8
// GFLOP per launch against 67 TFLOP/s. Each thread holds its row and two
// sets of K accumulators (3K values) in registers: the larger buckets spill
// (see the build's ptxas report). X is re-read by every (tile, restart)
// block; the restart index is fastest in the grid so co-resident blocks
// share an X tile in the 50 MB L2.
//
// K buckets 8..64 hold the row in registers; any larger multiple of 8 runs
// the wide variant (common.cuh): row read from F, accumulators in the output
// buffers, the same sums in the same order. Padded rows, contraction entries
// and K columns are exact no-ops: rows past M are not stored, entries past C
// add 0 . g(0) to the denominator (0 for every beta) and 0 to the numerator,
// and a zero K column of Fo adds nothing to wh and receives 0.

#include "common.cuh"

namespace {

using cnmf::kThreads;
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

// grid (B, tiles); X element (m, c) at X[m * sxm + c * sxc]; F (B, M, K) owns
// the rows, Fo (B, C, K) is contracted over; num and den (B, M, K).
template <int K, bool IS>
__global__ void __launch_bounds__(kThreads)
beta_terms_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                  long long sxc, const float* __restrict__ Fo,
                  const float* __restrict__ F, float beta,
                  float* __restrict__ num, float* __restrict__ den) {
  __shared__ float xs[kChunk][kThreads + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const float* fo = Fo + (size_t)b * C * K;
  const size_t off = (size_t)b * M * K;

  float f[1][K], an[1][K], ad[1][K];
  cnmf::load_rows<K, 1>(f, F + off, m0, M);
#pragma unroll
  for (int k = 0; k < K; ++k) an[0][k] = ad[0][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    cnmf::stage_chunk<K, kThreads, kChunk>(xs, fs, X, M, C, sxm, sxc, fo, m0,
                                           c0);
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
  cnmf::store_rows<K, 1>(num + off, an, m0, M);
  cnmf::store_rows<K, 1>(den + off, ad, m0, M);
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

template <bool IS>
int launch(const float* X, int M, int C, long long sxm, long long sxc,
           const float* Fo, const float* F, int B, int K, float beta,
           float* num, float* den, cudaStream_t stream) {
  const dim3 grid(B, (M + kThreads - 1) / kThreads);
#define BETA_CASE(KK)                                                     \
  case KK:                                                                \
    beta_terms_kernel<KK, IS><<<grid, kThreads, 0, stream>>>(             \
        X, M, C, sxm, sxc, Fo, F, beta, num, den);                        \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(BETA_CASE) }
#undef BETA_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  beta_terms_wide<IS><<<grid, kThreads, 0, stream>>>(X, M, C, sxm, sxc, Fo, F,
                                                     K, beta, num, den);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// num (B, M, K) = sum_c X(m, c) . f(wh) . F_other[c] and den (B, M, K) =
// sum_c g(wh) . F_other[c], wh = F[m] . F_other[c], X(m, c) = X[m * sxm +
// c * sxc]; F (B, M, K), F_other (B, C, K); beta not in {1, 2}.
int mu_beta_terms(const float* X, int M, int C, long long sxm, long long sxc,
                  const float* F_other, const float* F, int B, int K,
                  float beta, float* num, float* den, void* stream) {
  if (beta == 1.f || beta == 2.f) return (int)cudaErrorInvalidValue;
  if (beta == 0.f)
    return launch<true>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num, den,
                        (cudaStream_t)stream);
  return launch<false>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num, den,
                       (cudaStream_t)stream);
}

}  // extern "C"
