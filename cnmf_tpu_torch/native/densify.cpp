// Threaded CSR host kernels (float32/float64 data, int32/int64 indices),
// copied from the JAX package's native/densify.cpp, with the column
// moments' per-thread sums merged in thread order (deterministic).
//
// The largest host-side cost at atlas scale is expanding the sparse counts /
// TPM matrices into the dense layout the device kernels consume, and
// scipy's .toarray() is single-threaded. Rows are independent, so this
// parallelizes embarrassingly with OpenMP. Loaded via ctypes — no pybind11
// dependency (see cnmf_tpu_torch/native/__init__.py for the build-on-first-
// use logic and the scipy fallback).
//
// Index types: scipy promotes CSR indices AND indptr to int64 once
// nnz >= 2^31 (>2.1B-nnz atlases), so every kernel is templated over the
// stored-index type. Column-index VALUES always fit int32 (bounded by the
// gene count), but the arrays arrive as int64 and recasting 2B+ entries
// would cost an 8+ GB first-touch pass — the _i64 entry points stream them
// in place instead.

#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

namespace {

template <typename DataT, typename OutT, typename IdxT>
void densify_impl(const DataT* data, const IdxT* indices,
                  const int64_t* indptr, int64_t n_rows, int64_t n_cols,
                  OutT* out) {
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t i = 0; i < n_rows; ++i) {
        OutT* row = out + i * n_cols;
        std::memset(row, 0, sizeof(OutT) * n_cols);
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            row[indices[p]] = static_cast<OutT>(data[p]);
        }
    }
}

// One-pass per-column sum / sum-of-squares over CSR nonzeros (the moments
// feeding per-gene mean/variance; numpy needs two bincount passes plus a
// transient squared-data copy). Thread-local accumulators over static
// nnz ranges, merged serially in thread order after the parallel pass, so
// a run's sums do not depend on which thread finishes first (and int32 and
// int64 indices give the same bits) — n_cols doubles are tiny next to the
// nnz stream.
template <typename DataT, typename IdxT>
void col_moments_impl(const DataT* data, const IdxT* indices, int64_t nnz,
                      int64_t n_cols, double* sum_out, double* sumsq_out) {
    std::vector<std::vector<double>> ls, lq;
#pragma omp parallel
    {
#pragma omp single
        {
            ls.resize((size_t)omp_get_num_threads());
            lq.resize((size_t)omp_get_num_threads());
        }
        const size_t t = (size_t)omp_get_thread_num();
        ls[t].assign((size_t)n_cols, 0.0);
        lq[t].assign((size_t)n_cols, 0.0);
        double* s = ls[t].data();
        double* q = lq[t].data();
#pragma omp for schedule(static)
        for (int64_t p = 0; p < nnz; ++p) {
            const double v = (double)data[p];
            const IdxT c = indices[p];
            s[c] += v;
            q[c] += v * v;
        }
    }
    for (size_t t = 0; t < ls.size(); ++t) {
        for (int64_t j = 0; j < n_cols; ++j) {
            sum_out[j] += ls[t][j];
            sumsq_out[j] += lq[t][j];
        }
    }
}

template <typename IdxT>
int64_t col_subset_count_impl(const IdxT* indices, int64_t nnz,
                              const int32_t* lookup) {
    int64_t kept = 0;
#pragma omp parallel for schedule(static) reduction(+ : kept)
    for (int64_t p = 0; p < nnz; ++p) {
        kept += lookup[indices[p]] >= 0 ? 1 : 0;
    }
    return kept;
}

// Column subset of a CSR matrix through a gather table (lookup[j] = output
// column of input column j, or -1 to drop). Two phases so the caller can
// allocate exact-size outputs: a counting pass, then a sequential fill
// (both memory-bound streams; numpy needs ~5 intermediate nnz-length
// arrays for the same result, each paying first-touch faults).
// OutIdxT matches the caller's scipy index dtype so the rebuilt matrix
// needs no post-hoc upcast.
template <typename DataT, typename IdxT, typename OutIdxT>
void col_subset_fill_impl(const DataT* data, const IdxT* indices,
                          const int64_t* indptr, int64_t n_rows,
                          const int32_t* lookup, DataT* out_data,
                          OutIdxT* out_indices, int64_t* out_indptr) {
    int64_t pos = 0;
    out_indptr[0] = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int32_t nc = lookup[indices[p]];
            if (nc >= 0) {
                out_data[pos] = data[p];
                out_indices[pos] = static_cast<OutIdxT>(nc);
                ++pos;
            }
        }
        out_indptr[i + 1] = pos;
    }
}

}  // namespace

extern "C" {

// ---- int32 stored indices (nnz < 2^31; the historical entry points) ----

void densify_csr_f32(const float* data, const int32_t* indices,
                     const int64_t* indptr, int64_t n_rows, int64_t n_cols,
                     float* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

void densify_csr_f64(const double* data, const int32_t* indices,
                     const int64_t* indptr, int64_t n_rows, int64_t n_cols,
                     double* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

// CSR f64 -> dense f32 with direct cast (the common path: float64 h5ad
// counts feeding float32 device buffers without an intermediate f64 dense)
void densify_csr_f64_to_f32(const double* data, const int32_t* indices,
                            const int64_t* indptr, int64_t n_rows,
                            int64_t n_cols, float* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

void csr_col_moments_f64(const double* data, const int32_t* indices,
                         int64_t nnz, int64_t n_cols,
                         double* sum_out, double* sumsq_out) {
    col_moments_impl(data, indices, nnz, n_cols, sum_out, sumsq_out);
}

void csr_col_moments_f32(const float* data, const int32_t* indices,
                         int64_t nnz, int64_t n_cols,
                         double* sum_out, double* sumsq_out) {
    col_moments_impl(data, indices, nnz, n_cols, sum_out, sumsq_out);
}

int64_t csr_col_subset_count(const int32_t* indices, int64_t nnz,
                             const int32_t* lookup) {
    return col_subset_count_impl(indices, nnz, lookup);
}

void csr_col_subset_fill_f64(const double* data, const int32_t* indices,
                             const int64_t* indptr, int64_t n_rows,
                             const int32_t* lookup, double* out_data,
                             int32_t* out_indices, int64_t* out_indptr) {
    col_subset_fill_impl(data, indices, indptr, n_rows, lookup, out_data,
                         out_indices, out_indptr);
}

void csr_col_subset_fill_f32(const float* data, const int32_t* indices,
                             const int64_t* indptr, int64_t n_rows,
                             const int32_t* lookup, float* out_data,
                             int32_t* out_indices, int64_t* out_indptr) {
    col_subset_fill_impl(data, indices, indptr, n_rows, lookup, out_data,
                         out_indices, out_indptr);
}

// ---- int64 stored indices (scipy's dtype once nnz >= 2^31) ----

void densify_csr_f32_i64(const float* data, const int64_t* indices,
                         const int64_t* indptr, int64_t n_rows,
                         int64_t n_cols, float* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

void densify_csr_f64_i64(const double* data, const int64_t* indices,
                         const int64_t* indptr, int64_t n_rows,
                         int64_t n_cols, double* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

void densify_csr_f64_to_f32_i64(const double* data, const int64_t* indices,
                                const int64_t* indptr, int64_t n_rows,
                                int64_t n_cols, float* out) {
    densify_impl(data, indices, indptr, n_rows, n_cols, out);
}

void csr_col_moments_f64_i64(const double* data, const int64_t* indices,
                             int64_t nnz, int64_t n_cols,
                             double* sum_out, double* sumsq_out) {
    col_moments_impl(data, indices, nnz, n_cols, sum_out, sumsq_out);
}

void csr_col_moments_f32_i64(const float* data, const int64_t* indices,
                             int64_t nnz, int64_t n_cols,
                             double* sum_out, double* sumsq_out) {
    col_moments_impl(data, indices, nnz, n_cols, sum_out, sumsq_out);
}

int64_t csr_col_subset_count_i64(const int64_t* indices, int64_t nnz,
                                 const int32_t* lookup) {
    return col_subset_count_impl(indices, nnz, lookup);
}

// i64-index inputs keep i64 output indices: the rebuilt scipy matrix keeps
// one uniform index dtype with zero recast passes over nnz-length arrays
void csr_col_subset_fill_f64_i64(const double* data, const int64_t* indices,
                                 const int64_t* indptr, int64_t n_rows,
                                 const int32_t* lookup, double* out_data,
                                 int64_t* out_indices, int64_t* out_indptr) {
    col_subset_fill_impl(data, indices, indptr, n_rows, lookup, out_data,
                         out_indices, out_indptr);
}

void csr_col_subset_fill_f32_i64(const float* data, const int64_t* indices,
                                 const int64_t* indptr, int64_t n_rows,
                                 const int32_t* lookup, float* out_data,
                                 int64_t* out_indices, int64_t* out_indptr) {
    col_subset_fill_impl(data, indices, indptr, n_rows, lookup, out_data,
                         out_indices, out_indptr);
}

}  // extern "C"
