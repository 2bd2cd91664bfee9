"""Single-cell count simulator with planted expression programs.

Counterpart of the external ``scsim`` simulator the reference's tutorials and
test fixtures depend on (reference Extras/prepare_unittest_simulation.ipynb):
cells belong to identity groups (identity GEPs), a subset of cells
additionally run activity programs with continuous usage, gene relative
expression is lognormal with group/program-specific multipliers on marker
genes, and counts are Poisson draws scaled by per-cell library size.

Returns the ground-truth usage/spectra matrices so recovery can be scored.
The same numpy code as ``cnmf_tpu.simulate``, on the port's ``AnnData``: the
same seed gives the same counts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from cnmf_tpu_torch.io.anndata_lite import AnnData


def simulate_counts(
    n_cells: int = 2500,
    n_genes: int = 5000,
    n_identities: int = 6,
    n_activities: int = 1,
    activity_frac: float = 0.3,
    n_markers_per_program: int = 100,
    marker_fold: float = 6.0,
    mean_library_size: float = 5000.0,
    seed: int = 0,
) -> Tuple[AnnData, pd.DataFrame, pd.DataFrame]:
    """Simulate a counts matrix with identity + activity programs.

    Returns (adata, true_usages cells × programs, true_spectra programs × genes).
    """
    rng = np.random.RandomState(seed)
    n_programs = n_identities + n_activities

    # lognormal baseline relative expression per gene
    base = rng.lognormal(mean=0.0, sigma=1.0, size=n_genes)

    # each program up-regulates a disjoint marker block
    spectra = np.tile(base, (n_programs, 1))
    marker_sets = []
    perm = rng.permutation(n_genes)
    for p in range(n_programs):
        markers = perm[p * n_markers_per_program:(p + 1) * n_markers_per_program]
        folds = marker_fold * rng.lognormal(0.0, 0.3, size=len(markers))
        spectra[p, markers] *= folds
        marker_sets.append(markers)
    spectra = spectra / spectra.sum(axis=1, keepdims=True)

    # usages: one identity per cell (+ activity usage for a fraction)
    identity = rng.randint(0, n_identities, size=n_cells)
    usage = np.zeros((n_cells, n_programs))
    usage[np.arange(n_cells), identity] = 1.0
    for a in range(n_activities):
        on = rng.rand(n_cells) < activity_frac
        strength = rng.beta(2.0, 4.0, size=n_cells) * on
        usage[:, n_identities + a] = strength
    usage = usage / usage.sum(axis=1, keepdims=True)

    # counts ~ Poisson(library_size * usage @ spectra)
    libs = rng.lognormal(np.log(mean_library_size), 0.35, size=n_cells)
    rates = (usage @ spectra) * libs[:, None]
    counts = rng.poisson(rates).astype(np.float64)
    zero_cells = counts.sum(axis=1) == 0
    counts[zero_cells, 0] = 1

    obs = pd.DataFrame(
        {"identity": [f"ident_{i}" for i in identity],
         "library_size": libs},
        index=pd.Index([f"cell_{i}" for i in range(n_cells)]),
    )
    var = pd.DataFrame(index=pd.Index([f"gene_{j}" for j in range(n_genes)]))
    adata = AnnData(counts, obs=obs, var=var)

    program_names = [f"identity_{i}" for i in range(n_identities)] + [
        f"activity_{a}" for a in range(n_activities)
    ]
    usage_df = pd.DataFrame(usage, index=obs.index, columns=program_names)
    spectra_df = pd.DataFrame(spectra, index=program_names, columns=var.index)
    return adata, usage_df, spectra_df
