// What the hand-written kernels of this directory share: the block shape, the
// K buckets they are instantiated for, row loads and stores of a (B, M, K)
// factor held in registers, the staging of an X tile in shared memory, the
// block reduction of per-thread partials, and the helpers of the wide
// (runtime-K) variants.
#pragma once

#include <cuda_runtime.h>

namespace cnmf {

constexpr int kThreads = 128;
// K buckets held in registers: multiples of 8 up to 64 (the solvers zero-pad
// K to a multiple of 8). Any larger multiple of 8 runs a wide variant whose
// row and accumulators live in device memory (is_wide_k).
constexpr int kRegMaxK = 64;
#define CNMF_K_BUCKETS(X) X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64)

inline bool is_wide_k(int K) { return K > kRegMaxK && K % 8 == 0; }

// R rows of K values per thread (row m0 + threadIdx.x + r * kThreads); rows
// past M load as 0.
template <int K, int R>
__device__ __forceinline__ void load_rows(float (&f)[R][K],
                                          const float* __restrict__ src, int m0,
                                          int M) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = m0 + threadIdx.x + r * kThreads;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M) v = *reinterpret_cast<const float4*>(src + (size_t)row * K + k);
      f[r][k] = v.x;
      f[r][k + 1] = v.y;
      f[r][k + 2] = v.z;
      f[r][k + 3] = v.w;
    }
  }
}

template <int K, int R>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&f)[R][K], int m0,
                                           int M) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = m0 + threadIdx.x + r * kThreads;
    if (row >= M) continue;
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(dst + (size_t)row * K + k) =
          make_float4(f[r][k], f[r][k + 1], f[r][k + 2], f[r][k + 3]);
  }
}

// dst[0..3] = the float4 at src (16-byte aligned).
__device__ __forceinline__ void ld4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// xs[c][m] = X(m0 + m, c0 + c) for an X tile of TM rows, X element (m, c) at
// X[m * sxm + c * sxc]. Entries past M or C load as 0, so a ragged edge is an
// exact no-op. Neighbouring threads walk whichever axis of X is contiguous;
// xs is padded by one column so the transposed writes spread over the banks.
template <int TM, int CHUNK>
__device__ __forceinline__ void stage_x(float (&xs)[CHUNK][TM + 1],
                                        const float* __restrict__ X, int M,
                                        int C, long long sxm, long long sxc,
                                        int m0, int c0) {
  const bool c_contiguous = sxc == 1;
  for (int i = threadIdx.x; i < TM * CHUNK; i += kThreads) {
    const int m = c_contiguous ? i / CHUNK : i % TM;
    const int c = c_contiguous ? i % CHUNK : i / TM;
    const int gm = m0 + m, gc = c0 + c;
    xs[c][m] = (gm < M && gc < C) ? X[gm * sxm + gc * sxc] : 0.f;
  }
}

// One contraction chunk into shared memory: the X tile (stage_x) and
// fs[c][:] = row c0 + c of the other factor fo (C, K), 0 past C.
template <int K, int TM, int CHUNK>
__device__ __forceinline__ void stage_chunk(float (&xs)[CHUNK][TM + 1],
                                            float (&fs)[CHUNK][K],
                                            const float* __restrict__ X, int M,
                                            int C, long long sxm, long long sxc,
                                            const float* __restrict__ fo,
                                            int m0, int c0) {
  stage_x<TM, CHUNK>(xs, X, M, C, sxm, sxc, m0, c0);
  for (int i = threadIdx.x; i < CHUNK * K; i += kThreads) {
    const int c = i / K;
    fs[c][i % K] = c0 + c < C ? fo[(size_t)c0 * K + i] : 0.f;
  }
}

// ---- asynchronous copies from device memory to shared memory ----
// cp.async (sm_80 and later): the copy runs while the thread goes on; a
// group of copies is committed, and wait_group<N> blocks until at most N of
// the thread's groups are still in flight (a __syncthreads after it makes
// every thread's copies visible). The bytes past `bytes` of a copy are
// zero-filled, so a ragged edge reads nothing out of bounds; src must be a
// valid address even when nothing is read.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes (dst and src 16-byte aligned), of which `bytes` (0..16) are read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, of which `bytes` (0 or 4) are read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[o * PITCH + i] = src[o * s_out + i] for a tile of OUT x IN entries
// whose inner axis is contiguous in device memory, one 4-byte copy an entry
// (for a tile whose rows need not start 16-byte aligned); entries with o >=
// n_out or i >= n_in are zero-filled. Started by the NT threads of the
// block, not committed.
template <int OUT, int IN, int PITCH, int NT>
__device__ __forceinline__ void stage_tile_async4(float* dst,
                                                  const float* __restrict__ src,
                                                  long long s_out, int n_out,
                                                  int n_in) {
  for (int u = threadIdx.x; u < OUT * IN; u += NT) {
    const int o = u / IN, i = u % IN;
    const bool ok = o < n_out && i < n_in;
    cp_async4(dst + o * PITCH + i, ok ? src + o * s_out + i : src, ok ? 4 : 0);
  }
}

// Block sum of v; thread 0 writes it to *out. Every thread must call it.
template <typename T>
__device__ __forceinline__ void block_sum_to(T v, T* out) {
  __shared__ T warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    *out = s;
  }
}

// ---- wide variants (K above the register buckets) ----
// A thread's factor row and accumulators are K-long rows in device memory
// (read through L1/L2). The other factor's rows fo[c] are read from device
// memory too: every thread of a block reads the same address, one broadcast
// per warp. A chunk of CHUNK contraction entries is handled at a time, so
// each load of an accumulator serves CHUNK FMAs, and rows move as float4
// (K is a multiple of 8, so every row starts 32-byte aligned). Every sum
// runs in the same order as in the register kernels (k ascending for a dot,
// c ascending for an accumulator), so both give the same bits. Entries
// c >= nc are past the contraction axis and skipped (the register kernels
// add exact zeros there).

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// wh[c] = f . fo[c] for c < nc.
template <int CHUNK>
__device__ __forceinline__ void wide_dots(float (&wh)[CHUNK],
                                          const float* __restrict__ f,
                                          const float* __restrict__ fo, int K,
                                          int nc) {
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) wh[c] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float4 fk = *reinterpret_cast<const float4*>(f + k);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (c >= nc) continue;
      const float4 o = ldg4(fo + (size_t)c * K + k);
      wh[c] = fmaf(fk.x, o.x, wh[c]);
      wh[c] = fmaf(fk.y, o.y, wh[c]);
      wh[c] = fmaf(fk.z, o.z, wh[c]);
      wh[c] = fmaf(fk.w, o.w, wh[c]);
    }
  }
}

// acc[k] += sum over c < nc of v[c] . fo[c][k], c ascending.
template <int CHUNK>
__device__ __forceinline__ void wide_accumulate(float* __restrict__ acc,
                                                const float (&v)[CHUNK],
                                                const float* __restrict__ fo,
                                                int K, int nc) {
  for (int k = 0; k < K; k += 4) {
    float4 a = *reinterpret_cast<const float4*>(acc + k);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (c >= nc) continue;
      const float4 o = ldg4(fo + (size_t)c * K + k);
      a.x = fmaf(v[c], o.x, a.x);
      a.y = fmaf(v[c], o.y, a.y);
      a.z = fmaf(v[c], o.z, a.z);
      a.w = fmaf(v[c], o.w, a.w);
    }
    *reinterpret_cast<float4*>(acc + k) = a;
  }
}

}  // namespace cnmf
