// Fused KL multiplicative-update terms for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_mu.py:
//   kl_mu_w_numerator (:89, body _kl_w_terms_kernel :59)        -> mu_kl_numerator, W side
//   kl_mu_h_numerator (:394, body _make_kl_h_terms_kernel :128) -> mu_kl_numerator, H side
//   kl_x_log_wh (:357, body _make_kl_xlogwh_kernel :327)        -> mu_kl_x_log_wh
// The two general-beta kernels of that file (beta_mu_w_terms,
// beta_mu_h_terms) are in mu_beta.cu, on the same design.
//
// All three contract the reconstruction WH = W . Ht^T (N x G per restart)
// against X without ever writing it to memory. One block owns one row tile of
// one restart of the factor F whose rows index the output, and loops over the
// whole contraction axis itself, staging chunks of X and of the other factor
// Fo in shared memory. Each thread owns one row: it keeps the row of F (K
// values) and, for the numerators, K accumulators in registers, and for each
// staged contraction entry c computes
//   wh    = F[m] . Fo[c]                      (K FMAs)
//   ratio = X(m, c) / max(wh, eps)
//   acc  += ratio * Fo[c]                     (K FMAs)
// so num[m] = sum_c X(m, c) / max(wh, eps) . Fo[c]. With F = W, Fo = Ht and X
// read by rows this is (X / max(WH, eps)) . H^T; with F = Ht, Fo = W and X
// read transposed it is W^T . (X / max(WH, eps)) in the Ht layout. X's strides
// are arguments, so the same kernel also reads a transposed view of X (the
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
// staged element and restart a numerator spends 2K FMAs plus one IEEE
// division (about ten instructions; skipped where X is 0, which would take
// the division's slow path); at the PBMC-3k factorize shape (B=100, N=2700,
// G=2000, K=16) that is 4.N.G.K.B = 34.6 GFLOP per launch against 67 TFLOP/s
// of f32 FMA. X (21.6 MB there) is re-read by every (tile, restart) block; the
// restart index is fastest in the grid so co-resident blocks share an X tile
// in the 50 MB L2. The other factor's chunk is read from shared memory as a
// broadcast. One row per thread keeps the row and its accumulators (2K
// values) in registers (at K = 56 and 64 the compiler, caching the staged
// row as well, spills 24-28 bytes), and makes the grid N/128 x B blocks: 79
// blocks even for the B = 1 consensus spectra refit at 10000 genes.
//
// Padded rows, contraction entries and K columns are exact no-ops: rows past
// M and entries past C load as 0 (ratio 0), and a zero K column of Fo adds
// nothing to wh and receives 0.
//
// K buckets 8..64 hold the row in registers; any larger multiple of 8 runs a
// wide variant (common.cuh) with the row read from F and the accumulators in
// the output buffer, the same sums in the same order.

#include "common.cuh"

namespace {

using cnmf::kThreads;
constexpr int kChunk = 32;  // contraction entries staged per shared-memory round
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

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

// The same loop without accumulators: part[tile, b] = sum over the tile's
// rows and every c with X(m, c) > eps of X(m, c) . log(max(wh, eps)).
template <int K>
__global__ void __launch_bounds__(kThreads)
kl_x_log_wh_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                   long long sxc, const float* __restrict__ Fo,
                   const float* __restrict__ F, double* __restrict__ part) {
  __shared__ float xs[kChunk][kThreads + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const float* fo = Fo + (size_t)b * C * K;

  float f[1][K];
  cnmf::load_rows<K, 1>(f, F + (size_t)b * M * K, m0, M);
  double sum = 0.0;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    cnmf::stage_chunk<K, kThreads, kChunk>(xs, fs, X, M, C, sxm, sxc, fo, m0,
                                           c0);
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
  cnmf::block_sum_to(sum, part + (size_t)blockIdx.y * gridDim.x + b);
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

}  // namespace

extern "C" {

// Rows one block owns (sizes the (tiles, B) partials of mu_kl_x_log_wh).
int mu_tile_rows() { return kThreads; }

// out (B, M, K) = sum_c X(m, c) / max(F[m] . F_other[c], eps) . F_other[c],
// X(m, c) = X[m * sxm + c * sxc]; F (B, M, K), F_other (B, C, K).
int mu_kl_numerator(const float* X, int M, int C, long long sxm, long long sxc,
                    const float* F_other, const float* F, int B, int K,
                    float* out, void* stream) {
#define MU_CASE(KK)                                                       \
  case KK:                                                                \
    kl_numerator_kernel<KK><<<grid_of(B, M), kThreads, 0,                 \
                              (cudaStream_t)stream>>>(X, M, C, sxm, sxc,  \
                                                      F_other, F, out);   \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(MU_CASE) }
#undef MU_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  kl_numerator_wide<<<grid_of(B, M), kThreads, 0, (cudaStream_t)stream>>>(
      X, M, C, sxm, sxc, F_other, F, K, out);
  return (int)cudaGetLastError();
}

// part (tiles, B): per (row tile, restart) the sum over X(m, c) > eps of
// X(m, c) . log(max(F[m] . F_other[c], eps)).
int mu_kl_x_log_wh(const float* X, int M, int C, long long sxm, long long sxc,
                   const float* F_other, const float* F, int B, int K,
                   double* part, void* stream) {
#define MU_CASE(KK)                                                      \
  case KK:                                                               \
    kl_x_log_wh_kernel<KK><<<grid_of(B, M), kThreads, 0,                 \
                             (cudaStream_t)stream>>>(X, M, C, sxm, sxc,  \
                                                     F_other, F, part);  \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(MU_CASE) }
#undef MU_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  kl_x_log_wh_wide<<<grid_of(B, M), kThreads, 0, (cudaStream_t)stream>>>(
      X, M, C, sxm, sxc, F_other, F, K, part);
  return (int)cudaGetLastError();
}

}  // extern "C"
