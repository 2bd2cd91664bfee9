// Fused HALS coordinate-descent half-sweeps for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_cd.py:
//   cd_w_half_sweep (:118, kernel body _make_w_kernel :84)  -> fused kernel, W half
//   cd_h_half_sweep (:162, kernel body _make_h_kernel :97)  -> fused kernel, H half
// Both are built on _column_sweep (:58), which is column_sweep() below. The
// products-given entry point runs the same sweep on a precomputed data product
// (the consensus refits of cnmf_tpu/ops/nmf.py:nnls_cd_from_products).
//
// One block owns one row tile (cells for W, genes for Ht) of one restart:
//   1. P = X . F_other - l1 for its tile, computed in the block's own body in
//      plain f32 FMA (no tensor cores, no TF32: sklearn parity needs full f32),
//      looping over the contraction axis in chunks staged through shared memory.
//      X's strides are arguments, so one kernel reads X row-major (W half) or
//      transposed (H half).
//   2. The K sequential column updates of the factor tile, held in registers
//      (each thread owns whole rows), with the (K, K) gram in shared memory.
//   3. The new tile, and one partial violation per (tile, restart). The partials
//      are summed outside with a plain reduction: no atomics, so every run
//      gives the same bits.
//
// What bounds it on an H100: the fused product's f32 FMA rate at K <= 16
// (2.N.G.K flops per restart per half-sweep against 67 TFLOP/s), then the
// re-reads of X: every (tile, restart) block streams its X tile again, which
// at the PBMC-3k size (X is 21.6 MB) comes from the 50 MB L2, not HBM. The
// design keeps the restart index fastest in the grid so that co-resident
// blocks share an X tile in L2, gives each thread RM.K accumulators (RM rows of
// K columns) so that every shared-memory value feeds RM.K or K FMAs, and keeps
// the factor tile in registers between the product and the sweep, so the
// factor is read and written exactly once per half-sweep.
//
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

#include "common.cuh"

namespace {

using cnmf::kThreads;
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
// diagonal, p has l1 subtracted. Returns the summed |projected gradient| over
// live columns. f and p are indexed only by the unrolled j, so they stay in
// registers when the column loop over t is rolled; the compares against t
// fold away where it is unrolled.
template <int K, int R>
__device__ __forceinline__ float column_sweep(float (&f)[R][K],
                                              const float (&p)[R][K],
                                              const float* __restrict__ gram) {
  float viol = 0.f;
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
        viol += fabsf(pgrad);
        const float fnew = fmaxf(ft - grad / hess, 0.f);
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j == t) f[r][j] = fnew;
      }
    }
  }
  return viol;
}

template <int K>
__device__ __forceinline__ void load_gram(float* gs, const float* __restrict__ gram) {
  for (int i = threadIdx.x; i < K * K; i += kThreads) gs[i] = gram[i];
}

// grid (B, tiles); X element (m, c) at X[m * sxm + c * sxc].
template <int K>
__global__ void __launch_bounds__(kThreads)
cd_fused_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ Fo,
                const float* __restrict__ F, const float* __restrict__ gram,
                float l1, float* __restrict__ Fout,
                float* __restrict__ viol_part) {
  constexpr int R = Tile<K>::kRows;
  constexpr int TM = Tile<K>::kTileM;
  __shared__ float xs[kChunk][TM + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  __shared__ float gs[K * K];

  const int b = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int tid = threadIdx.x;
  const float* fo = Fo + (size_t)b * C * K;
  load_gram<K>(gs, gram + (size_t)b * K * K);

  float p[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) p[r][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    cnmf::stage_chunk<K, TM, kChunk>(xs, fs, X, M, C, sxm, sxc, fo, m0, c0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float fv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) fv[k] = fs[c][k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xv = xs[c][tid + r * kThreads];
#pragma unroll
        for (int k = 0; k < K; ++k) p[r][k] = fmaf(xv, fv[k], p[r][k]);
      }
    }
  }
  __syncthreads();  // gs is visible to every thread

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool valid = m0 + tid + r * kThreads < M;
#pragma unroll
    for (int k = 0; k < K; ++k) p[r][k] = valid ? p[r][k] - l1 : 0.f;
  }
  float f[R][K];
  const size_t f_off = (size_t)b * M * K;
  cnmf::load_rows<K, R>(f, F + f_off, m0, M);
  const float v = column_sweep<K, R>(f, p, gs);
  cnmf::store_rows<K, R>(Fout + f_off, f, m0, M);
  cnmf::block_sum_to(v, viol_part + (size_t)blockIdx.y * gridDim.x + b);
}

// The same sweep on a precomputed product P (B, M, K).
template <int K>
__global__ void __launch_bounds__(kThreads)
cd_products_kernel(const float* __restrict__ P, int M,
                   const float* __restrict__ F, const float* __restrict__ gram,
                   float l1, float* __restrict__ Fout,
                   float* __restrict__ viol_part) {
  constexpr int R = Tile<K>::kRows;
  constexpr int TM = Tile<K>::kTileM;
  __shared__ float gs[K * K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  load_gram<K>(gs, gram + (size_t)b * K * K);

  const size_t off = (size_t)b * M * K;
  float p[R][K];
  cnmf::load_rows<K, R>(p, P + off, m0, M);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool valid = m0 + threadIdx.x + r * kThreads < M;
#pragma unroll
    for (int k = 0; k < K; ++k) p[r][k] = valid ? p[r][k] - l1 : 0.f;
  }
  float f[R][K];
  cnmf::load_rows<K, R>(f, F + off, m0, M);
  __syncthreads();
  const float v = column_sweep<K, R>(f, p, gs);
  cnmf::store_rows<K, R>(Fout + off, f, m0, M);
  cnmf::block_sum_to(v, viol_part + (size_t)blockIdx.y * gridDim.x + b);
}

// column_sweep() on a row f (updated in place) and its product p (l1 not yet
// subtracted), both in device memory, with the gram read from device memory.
__device__ __forceinline__ float column_sweep_wide(float* __restrict__ f,
                                                   const float* __restrict__ p,
                                                   const float* __restrict__ gram,
                                                   float l1, int K) {
  float viol = 0.f;
  for (int t = 0; t < K; ++t) {
    const float hess = __ldg(gram + t * K + t);
    float grad = 0.f;
    for (int j = 0; j < K; ++j) grad = fmaf(f[j], __ldg(gram + j * K + t), grad);
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
    v = column_sweep_wide(f, p, gram + (size_t)b * K * K, l1, K);
  }
  cnmf::block_sum_to(v, viol_part + (size_t)blockIdx.y * gridDim.x + b);
}

// cd_products_kernel for K above the register buckets.
__global__ void __launch_bounds__(kThreads)
cd_products_wide(const float* __restrict__ P, int M,
                 const float* __restrict__ F, const float* __restrict__ gram,
                 float l1, int K, float* __restrict__ Fout,
                 float* __restrict__ viol_part) {
  const int b = blockIdx.x;
  const int row = blockIdx.y * kThreads + threadIdx.x;
  float v = 0.f;
  if (row < M) {
    const size_t off = ((size_t)b * M + row) * K;
    float* f = Fout + off;
    for (int k = 0; k < K; ++k) f[k] = F[off + k];
    v = column_sweep_wide(f, P + off, gram + (size_t)b * K * K, l1, K);
  }
  cnmf::block_sum_to(v, viol_part + (size_t)blockIdx.y * gridDim.x + b);
}

dim3 wide_grid(int B, int M) { return dim3(B, (M + kThreads - 1) / kThreads); }

template <int K>
int launch_fused(const float* X, int M, int C, long long sxm, long long sxc,
                 const float* Fo, const float* F, const float* gram, float l1,
                 int B, float* Fout, float* viol_part, cudaStream_t stream) {
  constexpr int TM = Tile<K>::kTileM;
  const dim3 grid(B, (M + TM - 1) / TM);
  cd_fused_kernel<K><<<grid, kThreads, 0, stream>>>(X, M, C, sxm, sxc, Fo, F,
                                                    gram, l1, Fout, viol_part);
  return (int)cudaGetLastError();
}

template <int K>
int launch_products(const float* P, int M, const float* F, const float* gram,
                    float l1, int B, float* Fout, float* viol_part,
                    cudaStream_t stream) {
  constexpr int TM = Tile<K>::kTileM;
  const dim3 grid(B, (M + TM - 1) / TM);
  cd_products_kernel<K><<<grid, kThreads, 0, stream>>>(P, M, F, gram, l1, Fout,
                                                       viol_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows one block owns at K (sizes the (tiles, B) violation partials): a
// register bucket's tile, one row per thread for a wide K, 0 for a K that is
// not a positive multiple of 8.
int cd_tile_rows(int K) {
#define CD_CASE(KK) \
  case KK:          \
    return Tile<KK>::kTileM;
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  return cnmf::is_wide_k(K) ? kThreads : 0;
}

// One fused half-sweep. F (B, M, K) is updated against F_other (B, C, K) and
// X (M x C in element (m, c) = X[m * sxm + c * sxc]); gram (B, K, K) carries
// l2 on its diagonal. Writes Fout (B, M, K) and viol_part (tiles, B).
// P_scratch (B, M, K) is used for a wide K only (may be null otherwise).
int cd_half_sweep_fused(const float* X, int M, int C, long long sxm,
                        long long sxc, const float* F_other, const float* F,
                        const float* gram, float l1, int B, int K, float* Fout,
                        float* viol_part, float* P_scratch, void* stream) {
#define CD_CASE(KK)                                                        \
  case KK:                                                                 \
    return launch_fused<KK>(X, M, C, sxm, sxc, F_other, F, gram, l1, B,    \
                            Fout, viol_part, (cudaStream_t)stream);
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (!cnmf::is_wide_k(K) || P_scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cd_fused_wide<<<wide_grid(B, M), kThreads, 0, (cudaStream_t)stream>>>(
      X, M, C, sxm, sxc, F_other, F, gram, l1, K, Fout, P_scratch, viol_part);
  return (int)cudaGetLastError();
}

// One half-sweep from a precomputed product P (B, M, K).
int cd_half_sweep_products(const float* P, int M, const float* F,
                           const float* gram, float l1, int B, int K,
                           float* Fout, float* viol_part, void* stream) {
#define CD_CASE(KK)                                                  \
  case KK:                                                           \
    return launch_products<KK>(P, M, F, gram, l1, B, Fout, viol_part, \
                               (cudaStream_t)stream);
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  cd_products_wide<<<wide_grid(B, M), kThreads, 0, (cudaStream_t)stream>>>(
      P, M, F, gram, l1, K, Fout, viol_part);
  return (int)cudaGetLastError();
}

}  // extern "C"
