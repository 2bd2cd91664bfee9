#!/usr/bin/env python3
"""Times the two kernels of the consensus refits through their wrappers,
and the one-program consensus that launches them, for the port package
found under a directory, on one CUDA card:

    python3 chip_refit_ab.py DIR    # DIR/cnmf_tpu_torch is timed

The wrappers: the products-given CD sweep (``cd_sweep_from_products``, B=1,
M=10,000, K=16, l2 off and on) and the KL W numerator
(``kl_mu_w_numerator``) at the usage refit (B=1, X 2700 x 2000) and the
spectra refit (X^T, 10,000 x 2700, a transposed view), K=16. Per wrapper
call: host microseconds (a loop of 400 calls), device milliseconds (50
calls queued behind a sleeping kernel, ``chip_smoke.device_ms``) and the
milliseconds between two events around one call (median of 20,
``chip_smoke.timed_ms``). The consensus: ``chip_smoke.py``'s CD, KL and IS
paths (make_counts(2700, 10000), 2000 HVGs, K=10 x 100 restarts) factorized
once, then the one-program consensus at K=10 (``stages.consensus_arrays``,
fused) on their merged spectra: each wall of 7 synchronized runs after a
warm-up, and the device-busy seconds of one more under torch.profiler
(``chip_smoke.profiled``). To compare two versions, run them in turns in
one session on one card (parent, change, change, parent), e.g. with the
parent unpacked by ``git archive`` into the git-ignored ``_archive/``.
Prints two lines; exits 2 without a card."""

import os
import sys
import time

import numpy as np

# the helpers of the script beside this one, imported before DIR goes on
# the path (DIR may hold a chip_smoke.py of its own)
from chip_smoke import (IS_DENSITY_THRESHOLD, device_ms, make_counts,
                        profiled, run_stages, timed_ms)

CONSENSUS_RUNS = 7


def consensus_line(root, dev):
    """The one-program consensus at K=10 of the CD, KL and IS paths: each
    path's walls (s) and the device-busy seconds of a profiled run."""
    import torch

    from cnmf_tpu_torch.pipeline import stages

    counts = make_counts(2700, 10000)
    prep = stages.prepare_arrays(counts, num_highvar_genes=2000)
    Xd, tpm = (torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=dev) for a in (prep.norm, prep.tpm))
    parts = []
    for label, kwargs, dt in (
            ("CD", stages.nmf_run_params(), 0.5),
            ("KL", stages.nmf_run_params(beta_loss="kullback-leibler",
                                         max_iter=200), 0.5),
            ("IS", stages.nmf_run_params(beta_loss="itakura-saito",
                                         max_iter=200), IS_DENSITY_THRESHOLD)):
        _, merged, *_ = run_stages(counts, [10], 100, 2000, 10, dev,
                                   nmf_kwargs=kwargs, density_threshold=dt)

        def run(merged=merged[10], kwargs=kwargs, dt=dt):
            return stages.consensus_arrays(
                merged, 10, Xd, tpm, prep.tpm_std, prep.hvg_idx, kwargs,
                density_threshold=dt, fused=True)

        run()
        walls = []
        for _ in range(CONSENSUS_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        _, wall, busy, _ = profiled(run, n_top=0)
        parts.append(f"{label} " + " ".join(f"{w:.4f}" for w in walls)
                     + f" (median {np.median(walls):.4f}; profiled {wall:.4f},"
                     f" busy {busy:.4f})")
    return (f"[refit-ab] {root} one-program consensus K=10 (wall s of "
            f"{CONSENSUS_RUNS} runs; profiled run wall, device busy s): "
            + "; ".join(parts))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_refit_ab: no CUDA device", file=sys.stderr)
        return 2
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk

    assert ck.__file__.startswith(root), ck.__file__

    def host_us(fn, n=400):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return elapsed / n * 1e6

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    K = 16

    def card(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    avg = np.sqrt(1.0 / K)
    F = card(avg * np.abs(rng.randn(1, 10000, K)))
    gram = ck._gram(card(avg * np.abs(rng.randn(1, 2700, K))))
    P = card(rng.gamma(1.0, 1.0, (1, 10000, K))) * gram.diagonal(
        dim1=1, dim2=2)[:, None]
    calls = {f"products l2={l2:g}": (lambda l2=l2: ck.cd_sweep_from_products(
        F, gram, P, l2_reg=l2)) for l2 in (0.0, 0.2)}
    for label, N, G, view in (("usage", 2700, 2000, False),
                              ("spectra", 10000, 2700, True)):
        X = rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)
        a = np.sqrt(X.mean() / K)
        W, Ht = (card(a * np.abs(rng.randn(1, M, K))) for M in (N, G))
        Xd = card(np.ascontiguousarray(X.T)).T if view else card(X)
        calls[f"kl num {label}"] = (
            lambda Xd=Xd, W=W, Ht=Ht: mk.kl_mu_w_numerator(Xd, W, Ht))
    print(f"[refit-ab] {root} (host us, device ms, event ms): " + "; ".join(
        f"{name} {host_us(fn):.2f} / {device_ms(fn):.4f} / "
        f"{timed_ms(fn, reps=20):.4f}" for name, fn in calls.items()),
        flush=True)
    print(consensus_line(root, dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
