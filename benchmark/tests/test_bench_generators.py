"""The count generators: deterministic in the seed, the configured shape,
type and fill."""

import numpy as np
import pytest
import scipy.sparse as sp

from benchkit import cells, generate

BIG_SEED = 2 ** 31 + 4321


def small(name, **over):
    cfg = cells.load_json("configs", name)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("name, rows", [("pbmc3k", 300), ("pbmc68k", 400)])
def test_same_seed_same_counts(name, rows):
    cfg = small(name, n_cells=rows)
    a = generate.counts_for(cfg, BIG_SEED, "cpu")
    b = generate.counts_for(cfg, BIG_SEED, "cpu")
    c = generate.counts_for(cfg, BIG_SEED + 1, "cpu")
    dense = (lambda m: m.toarray()) if sp.issparse(a) else np.asarray
    assert np.array_equal(dense(a), dense(b))
    assert not np.array_equal(dense(a), dense(c))


def test_pbmc3k_shape_type_fill():
    cfg = small("pbmc3k", n_cells=400)
    X = generate.counts_for(cfg, BIG_SEED, "cpu")
    assert X.shape == (400, 13714) and X.dtype == np.int16
    assert (X.sum(axis=1) > 0).all()
    assert 0.15 < generate.fill(X) < 0.30


def test_pbmc68k_shape_type_fill():
    cfg = small("pbmc68k", n_cells=400)
    X = generate.counts_for(cfg, BIG_SEED, "cpu")
    assert sp.isspmatrix_csr(X) and X.dtype == np.float32
    assert X.shape == (400, 32738)
    assert (np.asarray(X.sum(axis=1)).ravel() > 0).all()
    # about 525 genes (1.6 %) detected in the median cell, the source's
    # median (configs/pbmc68k.json's assumed)
    genes = np.diff(X.indptr)
    assert 450 < np.median(genes) < 600
    assert 0.012 < generate.fill(X) < 0.022
