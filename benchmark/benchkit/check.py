"""The comparison that decides ``correct``: a job of the window, drawn from
the run's seed, against the plain reference (``benchkit.reference``), which
works out again from the same counts and the same seeds everything the
program derived.

The numbers compared, each against its limit in the cell's workload file:

* ``norm_gap``: the normalized HVG counts, relative Frobenius distance
  (different HVGs give different columns);
* ``spectra_gap``: a sample of restarts (``check.restarts_per_k`` of each
  K, drawn from the seed), each solved by the reference from its seed's
  init to the program's own n_iter: the worst relative Frobenius distance
  of the spectra;
* ``n_iter_gap``: the same restarts, the largest difference between the
  program's n_iter and the reference's own stop, in stopping-rule checks
  (CD checks every sweep, MU every 10 iterations);
* ``consensus_gap``: the consensus at the cell's K, worked out by the
  reference from the program's merged spectra: the worst relative
  Frobenius distance of spectra, usages, TPM spectra and score spectra;
* ``kselect_sil_gap`` and ``kselect_err_gap``: the k-selection rows,
  worked out from the program's merged spectra: the largest absolute
  silhouette difference and relative prediction-error difference.

The consensus and the k-selection follow the program's factorize output;
that stage is checked by itself on the sampled restarts.

``control_outputs`` runs the same reference one precision lower (prepare
in float32, every product in TF32) in the program's place: the control
that every limit has to catch.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from benchkit.reference import threefry
from benchkit.reference.consensus import consensus, k_stats
from benchkit.reference.prepare import prepare
from benchkit.reference.solvers import CHECK_EVERY, no_tf32, solve

NUMBERS = ("norm_gap", "spectra_gap", "n_iter_gap", "consensus_gap",
           "kselect_sil_gap", "kselect_err_gap")
CONSENSUS_PARTS = ("spectra", "usages", "spectra_tpm", "spectra_score")


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| (Frobenius), dense or sparse."""
    if sp.issparse(a) or sp.issparse(b):
        d = sp.csr_matrix(a, dtype=np.float64) - sp.csr_matrix(b, dtype=np.float64)
        num = np.sqrt((d.data ** 2).sum())
        den = np.sqrt((sp.csr_matrix(b, dtype=np.float64).data ** 2).sum())
        return float(num / den)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def restart_seeds(ks, n_iter: int, master: int) -> dict:
    """cNMF's replicate seeds: numpy's global stream seeded with the
    master seed, one integer in [1, 2^31 - 1) a restart, K-major. Returns
    {K: seeds}."""
    rng = np.random.RandomState(master)
    seeds = rng.randint(low=1, high=(2 ** 31) - 1, size=len(ks) * n_iter)
    ks = sorted(set(ks))
    return {k: seeds[i * n_iter:(i + 1) * n_iter] for i, k in enumerate(ks)}


def x_mean(norm) -> float:
    """X's mean as the init scales by it: the float32 values summed in
    float64."""
    if sp.issparse(norm):
        return float(np.sum(norm.data.astype(np.float32), dtype=np.float64)
                     / (norm.shape[0] * norm.shape[1]))
    return float(np.mean(np.asarray(norm, dtype=np.float32), dtype=np.float64))


def sample_restarts(cell: dict, rng) -> dict:
    """{K: restart positions} of the factorize sample."""
    per = int(cell["check"]["restarts_per_k"])
    n = int(cell["n_iter"])
    return {k: np.sort(rng.choice(n, size=min(per, n), replace=False))
            for k in sorted(set(cell["components"]))}


class Reference:
    """The reference's view of one job: its own prepare of the counts, and
    its solves, consensus and k-selection on the card at ``prec``."""

    def __init__(self, cell, counts, device, prec="f32", dtype=np.float64):
        no_tf32()
        self.cell, self.device, self.prec = cell, device, prec
        self.solver = "cd" if cell["beta_loss"] == "frobenius" else "mu"
        self.tpm, self.tpm_std, self.hvgs, self.norm = prepare(
            counts, cell["cfg"]["num_highvar_genes"], dtype)
        self.X = self._dense(self.norm)

    def _dense(self, M):
        """A float32 dense tensor on the device (a CSR matrix expanded
        there)."""
        if sp.issparse(M):
            M = sp.csr_matrix(M)
            return torch.sparse_csr_tensor(
                torch.as_tensor(M.indptr.astype(np.int64)),
                torch.as_tensor(M.indices.astype(np.int64)),
                torch.as_tensor(M.data.astype(np.float32)),
                size=M.shape).to(self.device).to_dense()
        return torch.as_tensor(np.asarray(M, dtype=np.float32),
                               device=self.device)

    def factorize(self, seeds: dict, sample: dict, target=None):
        """The sampled restarts, one batch: ({K: (S, K, G) spectra},
        {K: (S,) own n_iter}); ``target`` {K: (S,)}: the iteration counts
        whose spectra to return."""
        N, G = self.X.shape
        kmax = max(sample)
        mean = x_mean(self.norm)
        W0, H0, tgt = [], [], []
        for k, pos in sample.items():
            for j, r in enumerate(pos):
                w, h = threefry.restart_init(int(seeds[k][r]), mean, k, N, G)
                W0.append(np.pad(w, ((0, 0), (0, kmax - k))))
                H0.append(np.pad(h, ((0, 0), (0, kmax - k))))
                tgt.append(0 if target is None else int(target[k][j]))
        W0 = torch.as_tensor(np.stack(W0), device=self.device)
        H0 = torch.as_tensor(np.stack(H0), device=self.device)
        _, Ht, n_iter = solve(self.X, W0, H0, solver=self.solver,
                              tol=float(self.cell.get("tol", 1e-4)),
                              max_iter=int(self.cell["max_iter"]),
                              prec=self.prec,
                              target=None if target is None else tgt)
        spec = Ht.transpose(1, 2).double().cpu().numpy()
        n_iter = n_iter.cpu().numpy()
        out_s, out_n, at = {}, {}, 0
        for k, pos in sample.items():
            out_s[k] = spec[at:at + len(pos), :k]
            out_n[k] = n_iter[at:at + len(pos)]
            at += len(pos)
        return out_s, out_n

    def _fit(self):
        return dict(solver=self.solver, tol=float(self.cell.get("tol", 1e-4)),
                    max_iter=int(self.cell["max_iter"]), prec=self.prec)

    def consensus(self, merged):
        tpm = self._dense(self.tpm)
        try:
            return consensus(
                self._dense(merged), int(self.cell["consensus_k"]), self.X,
                tpm, self.tpm_std, self.hvgs,
                density_threshold=float(self.cell["density_threshold"]),
                neighborhood=float(self.cell["local_neighborhood_size"]),
                zero_safe=sp.issparse(self.tpm), **self._fit())
        finally:
            del tpm

    def kstats(self, merged_by_k: dict) -> dict:
        return {k: k_stats(self._dense(merged_by_k[k]), k, self.X,
                           **self._fit()) for k in sorted(merged_by_k)}


def program_outputs(out, sample: dict) -> dict:
    """What the program's job produced, in the comparison's layout."""
    spectra, n_iter = {}, {}
    for k, pos in sample.items():
        m = out.spectra[k].reshape(-1, k, out.spectra[k].shape[1])
        spectra[k], n_iter[k] = m[pos], np.asarray(out.n_iter[k])[pos]
    c = out.consensus
    return {"hvgs": np.asarray(out.hvg_idx), "norm": out.norm,
            "spectra": spectra, "n_iter": n_iter,
            "consensus": {p: getattr(c, p) for p in CONSENSUS_PARTS},
            "kstats": {int(k): (sil, err) for k, _, sil, err in out.kstats}}


def control_outputs(cell, counts, merged, seeds, sample, device,
                    prep_dtype=np.float32) -> dict:
    """The reference one precision lower, in the program's place: every
    product in TF32, the prepare at ``prep_dtype``."""
    low = Reference(cell, counts, device, prec="tf32", dtype=prep_dtype)
    spectra, n_iter = low.factorize(seeds, sample)
    return {"hvgs": low.hvgs, "norm": low.norm, "spectra": spectra,
            "n_iter": n_iter, "consensus": low.consensus(
                merged[int(cell["consensus_k"])]),
            "kstats": low.kstats({k: merged[k] for k in cell["kselect"]})}


def compare(cell, counts, side: dict, merged: dict, seeds: dict,
            sample: dict, device) -> dict:
    """The numbers of ``side`` (the program's outputs, or the control's)
    against the reference."""
    ref = Reference(cell, counts, device)
    nums = {"norm_gap": rel_gap(side["norm"], ref.norm)}
    spec, n_ref = ref.factorize(seeds, sample, target=side["n_iter"])
    every = CHECK_EVERY[ref.solver]
    nums["spectra_gap"] = max(rel_gap(side["spectra"][k][j], spec[k][j])
                              for k in sample for j in range(len(sample[k])))
    nums["n_iter_gap"] = max(
        float(np.max(np.abs(np.asarray(side["n_iter"][k], np.int64)
                            - n_ref[k]))) / every for k in sample)
    cons = ref.consensus(merged[int(cell["consensus_k"])])
    nums["consensus_gap"] = max(rel_gap(side["consensus"][p], cons[p])
                                for p in CONSENSUS_PARTS)
    ks = ref.kstats({k: merged[k] for k in cell["kselect"]})
    nums["kselect_sil_gap"] = max(abs(side["kstats"][k][0] - ks[k][0])
                                  for k in ks)
    nums["kselect_err_gap"] = max(abs(side["kstats"][k][1] - ks[k][1])
                                  / ks[k][1] for k in ks)
    return nums


def verdict(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit (a number without a limit, or not finite, fails)."""
    checks = {n: {"value": float(nums[n]), "limit": limits.get(n)}
              for n in NUMBERS if n in nums}
    ok = all(c["limit"] is not None and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok
