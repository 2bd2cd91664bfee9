"""Sparse host→device transfer: ship the CSR components, densify on the card.

Every solve wants a dense cells × genes matrix in device memory, but at atlas
scale the dense form is many times larger than the CSR it came from (the
100k × 20k validation configuration is 8 GB dense in float32 and about 2 GB
as data + indices at 12 % fill). Shipping the sparse triplet and expanding
it on the device moves those fewer bytes and skips the host densify. The
same function as ``cnmf_tpu.ops.device_densify``, in torch ops (the JAX
version is plain XLA, a scatter, with no Pallas kernel).

The expansion writes the nonzeros into a zeros tensor: row ids come from
``indptr`` by ``torch.searchsorted`` over the nonzeros' positions (no host
row-index array, which would itself be nnz × 8 bytes), and each nonzero's
place is the int64 flat index ``row · n_cols + col`` (100,000 × 20,000 =
2.0e9 places is within 7 % of int32's limit). The nonzeros go in blocks of
``BLOCK_NNZ``, so the index temporaries stay bounded beside the dense output.
Canonical CSR (duplicates summed first, as the JAX version does) has one
entry per place, so every element is written once and the result equals
the host densify of the same cast data bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.native import densify_csr

# nonzeros a block: the block's data, columns, positions, rows and flat
# indices (about 36 bytes a nonzero, 1.2 GB at this size) live beside the
# dense output
BLOCK_NNZ = 1 << 25


def device_densify_eligible(X, out_dtype, device) -> bool:
    """True when shipping ``X`` sparse and expanding it on ``device`` beats
    the dense upload: a sparse input, a CUDA device, the nonzeros and both
    dimensions in int32 range, the CSR bytes (data + 4-byte column indices)
    under half the dense bytes, and ``CNMF_TPU_DEVICE_DENSIFY`` not "0"
    (cnmf_tpu/ops/device_densify.py:84-99, whose "the backend is a TPU"
    becomes "the device is CUDA")."""
    if not sp.issparse(X):
        return False
    if os.environ.get("CNMF_TPU_DEVICE_DENSIFY", "1") != "1":
        return False
    if torch.device(device).type != "cuda":
        return False
    if X.nnz >= 2**31 or max(X.shape) >= 2**31:
        return False
    itemsize = np.dtype(out_dtype).itemsize
    sparse_bytes = X.nnz * (itemsize + 4)
    dense_bytes = X.shape[0] * X.shape[1] * itemsize
    return sparse_bytes < 0.5 * dense_bytes


def device_densify_csr(X, out_dtype=np.float32, device="cuda",
                       block_nnz: int = BLOCK_NNZ) -> torch.Tensor:
    """A dense tensor on ``device`` from a scipy sparse matrix, shipping only
    the CSR components. Equals ``torch.as_tensor(X.toarray().astype(
    out_dtype))`` element for element. Indices may be int32 or int64."""
    Xc = X.tocsr() if not sp.isspmatrix_csr(X) else X
    if not Xc.has_canonical_format:
        Xc = Xc.copy()
        Xc.sum_duplicates()
    nnz = Xc.nnz
    if nnz >= 2**31 or max(Xc.shape) >= 2**31:
        raise ValueError(
            f"device_densify_csr needs int32-addressable input (nnz={nnz}, "
            f"shape={Xc.shape}); device_densify_eligible gates this")
    n_rows, n_cols = Xc.shape
    data = Xc.data.astype(out_dtype, copy=False)
    dense = torch.zeros(n_rows * n_cols, dtype=torch.from_numpy(data[:0]).dtype,
                        device=device)
    indptr = torch.as_tensor(Xc.indptr, device=device).long()
    for start in range(0, nnz, block_nnz):
        stop = min(start + block_nnz, nnz)
        vals = torch.as_tensor(data[start:stop], device=device)
        cols = torch.as_tensor(Xc.indices[start:stop], device=device).long()
        pos = torch.arange(start, stop, dtype=torch.int64, device=device)
        rows = torch.searchsorted(indptr, pos, right=True) - 1
        dense.index_copy_(0, rows * n_cols + cols, vals)
        del vals, cols, pos, rows
    return dense.view(n_rows, n_cols)


def to_device_dense(X, out_dtype, device) -> torch.Tensor:
    """A (cells × features) host matrix as a dense tensor on ``device`` at
    ``out_dtype``: the CSR components expanded on the card when
    ``device_densify_eligible``, else the native host densify (a dense input
    cast) and one upload. A failed device expansion raises: it never
    falls back to the host."""
    if device_densify_eligible(X, out_dtype, device):
        return device_densify_csr(X, out_dtype, device)
    return torch.as_tensor(
        np.ascontiguousarray(densify_csr(X, out_dtype=out_dtype)),
        device=device)
