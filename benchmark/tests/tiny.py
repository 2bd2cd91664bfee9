"""A cell of the benchmark cut to a size the CPU tests hold, and a run of
it through ``run.main`` on the CPU (the harness's look for a card
skipped)."""

import io
import json
import os
from contextlib import redirect_stdout

CPU_KNOBS = {"CNMF_TPU_DEVICE_INIT": "force",
             "CNMF_TPU_DEVICE_KMEANSPP": "force"}


def tiny_cell(name="pbmc3k.cd-grid", beta_loss=None):
    from benchkit import cells

    cell = cells.cell(name)
    cell["cfg"] = dict(cell["cfg"], n_cells=240, n_genes=700,
                       num_highvar_genes=120)
    cell.update(components=[4, 5], n_iter=6, consensus_k=5, kselect=[4, 5],
                max_iter=200, check={"restarts_per_k": 3, "warm_iter": 10})
    if beta_loss:
        cell["beta_loss"] = beta_loss
    return cell


def run_tiny(cell, seed=2 ** 31 + 99, trace=0):
    """run.main on the CPU; returns (exit code, the result line)."""
    import run

    missing = [k for k, v in CPU_KNOBS.items() if os.environ.get(k) != v]
    assert not missing, f"set {missing} (the cpu_knobs fixture)"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", cell["name"], "--seed", str(seed),
                       "--seconds", "0", "--trace", str(trace)],
                      device="cpu", cell=cell)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None
