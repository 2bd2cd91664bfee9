"""One cNMF job through ``cnmf_tpu_torch.pipeline.stages``, as ``cNMF``'s
in-process path calls it: prepare, factorize (every K on the per-K device
ladder, the packed drain and the device twin; the per-restart spectra kept
in memory), combine, consensus at the cell's K (the one-program consensus
on the resident TPM, fed by the twin) and the k-selection table (fed by the
twins).

Each stage runs inside a span of the harness: the host clock around the
call, ended by a device synchronization, and a profiler annotation
``bench:<span>`` that places the span on a traced run's timeline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch


def job_seed(seed: int, job: int) -> int:
    """The restart seeds' master seed of job ``job`` of a run: 31 bits
    from the run's seed and the job's index."""
    state = np.random.SeedSequence([int(seed) % (2 ** 63), int(job)])
    return int(state.generate_state(1, np.uint32)[0] >> 1)


@dataclass
class JobOutput:
    seed: int
    hvg_idx: np.ndarray = None
    norm: object = None
    spectra: dict = field(default_factory=dict)    # K: merged (B·K, G)
    n_iter: dict = field(default_factory=dict)     # K: (B,) int
    consensus: object = None
    kstats: list = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's spans: (job, name, start, end) on the host clock."""

    def __init__(self, device):
        self.device = device
        self.rows = []

    def __call__(self, job: int, name: str):
        return _Span(self, job, name)


class _Span:
    def __init__(self, spans, job, name):
        self.spans, self.job, self.name = spans, job, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(f"bench:{self.name}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _sync(self.spans.device)
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        if exc[0] is None:
            self.spans.rows.append((self.job, self.name, self.t0, t1))


def run_job(cell: dict, counts, seed: int, device, spans: Spans,
            job: int) -> JobOutput:
    """One job of ``cell`` on a fresh copy of ``counts``, restart seeds from
    ``seed``."""
    from cnmf_tpu_torch.ops.device_densify import to_device_dense
    from cnmf_tpu_torch.pipeline import stages

    cfg = cell["cfg"]
    counts = counts.copy()
    ks = list(cell["components"])
    kwargs = stages.nmf_run_params(beta_loss=cell["beta_loss"],
                                   max_iter=int(cell["max_iter"]))
    out = JobOutput(seed=seed)
    with spans(job, "prepare"):
        prep = stages.prepare_arrays(counts,
                                     num_highvar_genes=cfg["num_highvar_genes"])
        grid, seeds = stages.replicate_seeds(ks, int(cell["n_iter"]), seed)
    out.hvg_idx, out.norm = prep.hvg_idx, prep.norm
    twins = {}
    with spans(job, "factorize"):
        if sp.issparse(prep.norm):
            X_host = prep.norm
            Xd = to_device_dense(prep.norm, np.float32, device)
        else:
            X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
            Xd = torch.as_tensor(X_host, device=device)
        jobs = [(k, seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]],
                 np.arange(int(cell["n_iter"]))) for k in sorted(set(ks))]

        def write(k, iters, batch, twin):
            out.spectra[k] = batch
            twins[k] = twin

        sweeps = stages.factorize_grid(X_host, Xd, jobs, kwargs, write,
                                       twin=True)
    out.n_iter = {k: np.asarray(v[0]) for k, v in sweeps.items()}

    def twin_of(k):
        t = twins.get(k)
        return out_merged(k) if t is None else t[0][t[1]:t[1] + t[2]]

    def out_merged(k):
        return stages.combine_arrays(list(out.spectra[k]))

    k_cons = int(cell["consensus_k"])
    with spans(job, "consensus"):
        merged = {k: out_merged(k) for k in out.spectra}
        tpm = to_device_dense(prep.tpm, np.float32, device)
        out.consensus = stages.consensus_arrays(
            twin_of(k_cons), k_cons, Xd, tpm, prep.tpm_std, prep.hvg_idx,
            kwargs, density_threshold=float(cell["density_threshold"]),
            local_neighborhood_size=float(cell["local_neighborhood_size"]),
            zero_safe=sp.issparse(prep.tpm))
        del tpm
    with spans(job, "kselect"):
        out.kstats = stages.k_stats_arrays(
            {k: twin_of(k) for k in cell["kselect"]}, Xd, kwargs)
    out.spectra = merged
    return out
