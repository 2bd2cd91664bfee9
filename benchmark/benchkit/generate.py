"""Synthetic count matrices, drawn from a seed with one ``torch.Generator``
on the device that runs the benchmark.

Two recipes, each named by a configuration's ``generator`` key:

* ``make_counts``: planted programs at a dense PBMC-3k shape (bench.py's
  recipe): W gamma(0.5, 1), H gamma(0.4, 1) kept with probability 0.15, a
  background gamma(0.3, 0.05) x 5 per gene, Poisson counts stored as int16.
* ``synthesize``: the atlas recipe (extras/atlas_validate.py) at a
  configured depth: W gamma(0.5, 1), H gamma(``h_shape``, 1) kept with
  probability ``h_density``, a background gamma(``background_shape``,
  ``background_scale``) per gene; each cell's rates scaled to sum to
  ``library`` counts, Poisson counts drawn in blocks of rows into a float32
  CSR matrix on the host.

In both a cell without counts gets one count of gene 0. The same seed on
the same device gives the same matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

BLOCK = 4096   # rows of Poisson rates drawn at a time by ``synthesize``


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _gamma(g, shape: float, size, device, scale: float = 1.0):
    return scale * torch._standard_gamma(
        torch.full(size, shape, dtype=torch.float32, device=device),
        generator=g)


def make_counts(cfg: dict, seed: int, device) -> np.ndarray:
    """(cells x genes) int16 counts of the ``make_counts`` recipe."""
    device = torch.device(device)
    g = _generator(seed, device)
    n, m, k = cfg["n_cells"], cfg["n_genes"], cfg["k_true"]
    W = _gamma(g, 0.5, (n, k), device)
    H = _gamma(g, 0.4, (k, m), device) * (
        torch.rand(k, m, device=device, generator=g) < 0.15)
    base = _gamma(g, 0.3, (m,), device, scale=0.05)
    counts = torch.poisson(W @ H + base[None, :] * 5.0, generator=g)
    counts[counts.sum(dim=1) == 0, 0] = 1.0
    return counts.to(torch.int16).cpu().numpy()


def synthesize(cfg: dict, seed: int, device) -> sp.csr_matrix:
    """(cells x genes) float32 CSR counts of the ``synthesize`` recipe."""
    device = torch.device(device)
    g = _generator(seed, device)
    n, m, k = cfg["n_cells"], cfg["n_genes"], cfg["k_true"]
    W = _gamma(g, 0.5, (n, k), device)
    H = _gamma(g, cfg["h_shape"], (k, m), device) * (
        torch.rand(k, m, device=device, generator=g) < cfg["h_density"])
    base = _gamma(g, cfg["background_shape"], (m,), device,
                  scale=cfg["background_scale"])
    data, indices, indptr = [], [], [np.zeros(1, np.int64)]
    for start in range(0, n, BLOCK):
        rate = W[start:start + BLOCK] @ H + base
        rate *= cfg["library"] / rate.sum(dim=1, keepdim=True)
        counts = torch.poisson(rate, generator=g)
        counts[counts.sum(dim=1) == 0, 0] = 1.0
        rows, cols = counts.nonzero(as_tuple=True)   # row-major order
        data.append(counts[rows, cols].cpu().numpy())
        indices.append(cols.to(torch.int32).cpu().numpy())
        per_row = torch.bincount(rows, minlength=counts.shape[0])
        indptr.append(torch.cumsum(per_row, 0).cpu().numpy()
                      + indptr[-1][-1])
    return sp.csr_matrix((np.concatenate(data), np.concatenate(indices),
                          np.concatenate(indptr)), shape=(n, m))


GENERATORS = {"make_counts": make_counts, "synthesize": synthesize}


def counts_for(cfg: dict, seed: int, device):
    """The configuration's counts from ``seed``."""
    return GENERATORS[cfg["generator"]](cfg, seed, device)


def fill(counts) -> float:
    """The share of entries that are nonzero."""
    nnz = counts.nnz if sp.issparse(counts) else int(np.count_nonzero(counts))
    return nnz / (counts.shape[0] * counts.shape[1])
