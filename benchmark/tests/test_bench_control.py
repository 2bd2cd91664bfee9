"""The control: the plain reference one precision lower than the
configurations state (prepare in float32, every product in TF32), put in
the program's place, has to come out not correct under each cell's limits.
On the CPU at a small size (TF32 is emulated by rounding the operands,
which is what a TF32 product does to them)."""

import numpy as np
import pytest

from benchkit import check
from tiny import tiny_cell

CELLS = ["pbmc3k.cd-grid", "pbmc3k.kl-grid", "pbmc68k.cd-k12"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cpu_knobs):
    from benchkit import generate

    cell = tiny_cell(name)
    limits = cell["limits"]
    if name.startswith("pbmc68k"):
        cell["cfg"].update(n_cells=400, n_genes=6000)
    counts = generate.counts_for(cell["cfg"], 2 ** 31 + 5, "cpu")
    rng = np.random.default_rng(3)
    sample = check.sample_restarts(cell, rng)
    seeds = check.restart_seeds(cell["components"], cell["n_iter"], 12345)
    # merged spectra to follow: the f32 reference's own factorize of every
    # restart
    ref = check.Reference(cell, counts, "cpu")
    full = {k: np.arange(cell["n_iter"]) for k in cell["components"]}
    spec, _ = ref.factorize(seeds, full)
    merged = {k: s.reshape(-1, s.shape[2]) for k, s in spec.items()}
    side = check.control_outputs(cell, counts, merged, seeds, sample, "cpu")
    nums = check.compare(cell, counts, side, merged, seeds, sample, "cpu")
    checks, ok = check.verdict(nums, limits)
    assert not ok, checks
