#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cnmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. environment: the card's name and power limit, torch/CUDA versions, and
   which of pandas, h5py, yaml and matplotlib import;
2. build: every kernel of csrc/ into one library (build seconds, ptxas
   report);
3. each kernel against its plain PyTorch version on the card (max relative
   difference, f32, bounded by KERNEL_REL_BOUND), with median times: the CD
   half-sweeps at the main path's shapes (K=8 and K=16 buckets) and the
   KL multiplicative-update kernels at the KL factorize shape (K=16, and K=8
   with zero columns) and the W numerator and the divergence at the
   consensus refits' two shapes, plus ragged shapes at every K bucket 8..64; then the slice at the verify recipe's
   size on the card against the same code on the CPU, with the frobenius
   (CD) and the kullback-leibler (MU) loss;
4. the main path end to end at PBMC-3k scale — bench.py's make_counts(2700,
   10000), 2000 HVGs, K=5..13 × 100 restarts, consensus at K=10 (density
   threshold 0.5) — through cNMF(device="cuda") when pandas, h5py and yaml
   import, else through the same four stages in pipeline/stages.py; the wall
   and sweeps of each K, stage walls and the CD kernels' launch counts, each
   of which must be > 0; then the smallest and largest K again under
   torch.profiler (device-busy time and idle share);
5. the KL path at bench.py's KL configuration — the same counts, K=10 × 100
   restarts with beta_loss="kullback-leibler" and at most 200 iterations,
   combine, consensus at K=10 — through pipeline/stages.py: stage walls,
   iterations and the MU kernels' launch counts, each of which must be > 0;
   then its factorize again under torch.profiler;
6. a JSON line of the kernels, the card line, and the result line
   {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it runs and read just
after.

Nothing is caught: any failure exits non-zero before the result line. With
no CUDA device the script exits 2 and prints no result.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_REL_BOUND = 1e-4   # max |kernel - plain| / max |plain|, f32
SMALL_SSE_BOUND = 1e-4    # the repo's consensus-artifact contract (SSE)
# the main path's two fused-kernel buckets: K=9..13 pad to 16, K=5..8 to 8
# (K=5 carries 3 zero columns)
MAIN = [(dict(B=100, N=2700, G=2000, K=16), 0),
        (dict(B=100, N=2700, G=2000, K=8), 3)]
REFIT = dict(B=1, M=10000, K=16)   # the consensus TPM-spectra refit
# ragged shapes (rows and contraction off the tile) at every K bucket, each
# with two zero K-bucket columns that must stay exactly zero: skipped (zero
# hessian) without regularization, live but pinned at 0 with it
REGS = dict(l1_reg=0.1, l2_reg=0.2)
RAGGED = [(dict(B=7, N=1001, G=333, K=8), {}),
          (dict(B=5, N=700, G=150, K=16), REGS),
          (dict(B=3, N=517, G=271, K=24), REGS),
          (dict(B=2, N=300, G=129, K=32), {}),
          (dict(B=3, N=450, G=77, K=40), REGS),
          (dict(B=2, N=333, G=90, K=48), {}),
          (dict(B=3, N=257, G=65, K=56), REGS),
          (dict(B=2, N=200, G=130, K=64), REGS)]
PAD_COLS = 2
# the KL factorize's buckets (K=10 pads to 16; K=8 with zero columns as a
# K=5 run pads), the consensus refits and ragged shapes at every bucket with
# B not a multiple of 4 and N off the 128-row tile. The refits hold H fixed,
# so they run the W numerator and the divergence only: the two usage refits
# on row-major X (2700 cells × 2000 HVGs), the spectra refit on X = TPMᵀ
# (10000 genes × 2700 cells, read as a transposed view)
MU_MAIN = [(dict(B=100, N=2700, G=2000, K=16), 0),
           (dict(B=100, N=2700, G=2000, K=8), 3)]
MU_REFIT = [(dict(B=1, N=2700, G=2000, K=16), "usage refit", False),
            (dict(B=1, N=10000, G=2700, K=16),
             "spectra refit, X a transposed view", True)]
MU_RAGGED = [dict(B=3 + 2 * (i % 3), N=300 + 37 * i, G=150 + 29 * i, K=K)
             for i, K in enumerate(range(8, 65, 8))]
MU_KERNELS = ("kl_mu_w_numerator", "kl_mu_h_numerator", "kl_x_log_wh")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def timed_ms(fn, reps=10):
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(kernel, plain):
    """(max abs error, max relative error) of a kernel result tuple against
    its plain version."""
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(kernel, plain):
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.abs().max()), 1e-30))
    return abs_err, rel_err


def phase_kernels(dev, card):
    """Kernel against plain on the card; returns {name: record}."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck

    rng = np.random.RandomState(0)

    def factors(B, N, G, K, pad):
        # the scale of sklearn's random init: sqrt(mean(X) / K) · |N(0, 1)|
        avg = np.sqrt(1.0 / K)
        X = rng.gamma(1.0, 1.0, (N, G)).astype(np.float32)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        return [torch.as_tensor(a, device=dev) for a in (X, W, Ht)]

    def check_pad(out, pad):
        assert pad == 0 or not out[0][:, :, -pad:].any(), "padding moved"

    records = {}
    cases = [(m, "main", {}, pad) for m, pad in MAIN] + [
        (r, "ragged", g, PAD_COLS) for r, g in RAGGED]
    for shape, tag, regs, pad in cases:
        X, W, Ht = factors(**shape, pad=pad)
        for name, kernel, plain in (
            ("cd_w_half_sweep", ck.cd_w_half_sweep, ck.cd_w_half_sweep_plain),
            ("cd_h_half_sweep", ck.cd_h_half_sweep, ck.cd_h_half_sweep_plain),
        ):
            out = kernel(X, W, Ht, **regs)
            check_pad(out, pad)
            abs_err, rel_err = compare(out, plain(X, W, Ht, **regs))
            ms = timed_ms(lambda: kernel(X, W, Ht, **regs))
            plain_ms = timed_ms(lambda: plain(X, W, Ht, **regs))
            print(f"[kernel] {name} {tag} {shape} {regs} zero K columns {pad}: "
                  f"max_rel_diff={rel_err:.3e} (bound {KERNEL_REL_BOUND:g}) "
                  f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}; card: {card}", flush=True)
            assert rel_err <= KERNEL_REL_BOUND, (name, tag, rel_err)
            if tag == "main":
                # the JSON line's times are the K=16 bucket's, the other
                # bucket's beside them; the error is the worst of both
                rec = records.setdefault(name, dict(max_abs_err=0.0))
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
                suffix = "" if shape["K"] == 16 else f"_k{shape['K']}"
                rec["ms" + suffix], rec["plain_ms" + suffix] = ms, plain_ms

    name = "cd_sweep_from_products"
    cases = [(REFIT, "main", {})] + [
        (dict(B=r["B"], M=r["N"], K=r["K"]), "ragged", g) for r, g in RAGGED]
    for shape, tag, regs in cases:
        B, M, K = shape["B"], shape["M"], shape["K"]
        avg = np.sqrt(1.0 / K)
        F = torch.as_tensor((avg * np.abs(rng.randn(B, M, K))).astype(np.float32),
                            device=dev)
        Hfix = torch.as_tensor(
            (avg * np.abs(rng.randn(B, 2700, K))).astype(np.float32), device=dev)
        gram = ck._gram(Hfix)
        P = torch.as_tensor(rng.gamma(1.0, 1.0, (B, M, K)).astype(np.float32),
                            device=dev) * gram.diagonal(dim1=1, dim2=2)[:, None]
        kernel, plain = ck.cd_sweep_from_products, ck.cd_sweep_from_products_plain
        abs_err, rel_err = compare(kernel(F, gram, P, **regs),
                                   plain(F, gram, P, **regs))
        ms = timed_ms(lambda: kernel(F, gram, P, **regs))
        plain_ms = timed_ms(lambda: plain(F, gram, P, **regs))
        print(f"[kernel] {name} {tag} {shape} {regs}: max_rel_diff={rel_err:.3e} "
              f"(bound {KERNEL_REL_BOUND:g}) max_abs_err={abs_err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}; card: {card}", flush=True)
        assert rel_err <= KERNEL_REL_BOUND, (name, tag, rel_err)
        if tag == "main":
            records[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
    return records


def phase_mu_kernels(dev, card):
    """The KL multiplicative-update kernels against their plain versions on
    the card; returns {name: record}."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk

    rng = np.random.RandomState(1)

    def problem(B, N, G, K, pad, transposed):
        # X like normalized counts (a third of it zero), factors at the scale
        # of sklearn's random init; a transposed X is a view of a (G, N)
        # buffer, as the spectra refit passes TPMᵀ
        X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
            np.float32)
        avg = np.sqrt(X.mean() / K)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        Xd = (torch.as_tensor(np.ascontiguousarray(X.T), device=dev).T
              if transposed else torch.as_tensor(X, device=dev))
        return Xd, torch.as_tensor(W, device=dev), torch.as_tensor(Ht, device=dev)

    records = {}
    refit_kernels = ("kl_mu_w_numerator", "kl_x_log_wh")
    cases = ([(m, "main", pad, False, MU_KERNELS) for m, pad in MU_MAIN]
             + [(m, tag, 0, tr, refit_kernels) for m, tag, tr in MU_REFIT]
             + [(r, "ragged", PAD_COLS, False, MU_KERNELS) for r in MU_RAGGED])
    for shape, tag, pad, transposed, names in cases:
        X, W, Ht = problem(**shape, pad=pad, transposed=transposed)
        for name in names:
            kernel, plain = getattr(mk, name), getattr(mk, name + "_plain")
            out = kernel(X, W, Ht)
            assert pad == 0 or out.ndim == 1 or not out[:, :, -pad:].any(), \
                "padding moved"
            abs_err, rel_err = compare([out], [plain(X, W, Ht)])
            ms = timed_ms(lambda: kernel(X, W, Ht))
            plain_ms = timed_ms(lambda: plain(X, W, Ht))
            print(f"[kernel] {name} {tag} {shape} zero K columns {pad}: "
                  f"max_rel_diff={rel_err:.3e} (bound {KERNEL_REL_BOUND:g}) "
                  f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}; card: {card}", flush=True)
            assert rel_err <= KERNEL_REL_BOUND, (name, tag, rel_err)
            if tag == "main":
                rec = records.setdefault(name, dict(max_abs_err=0.0))
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
                suffix = "" if shape["K"] == 16 else f"_k{shape['K']}"
                rec["ms" + suffix], rec["plain_ms" + suffix] = ms, plain_ms
    return records


def make_counts(n_cells, n_genes, seed=7):
    from bench import make_counts as bench_counts

    return bench_counts(n_cells, n_genes, seed=seed)


def run_stages(counts, ks, n_iter, hvg, k_cons, dev, dtype=np.float32,
               verbose=False, nmf_kwargs=None):
    """prepare → factorize → combine → consensus through pipeline/stages.py
    with ``nmf_kwargs`` (default: stages.nmf_run_params(), frobenius);
    returns (stage walls after a device synchronize, merged spectra at k_cons,
    consensus result, {K: sweeps of each restart}). ``verbose``: a line per K
    with its wall and sweeps, as cNMF.factorize prints."""
    import torch

    from cnmf_tpu_torch.pipeline import stages

    def wall(t0):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {}
    t0 = time.perf_counter()
    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=dtype)
    Xd = torch.as_tensor(X_host, device=dev)
    tpm = torch.as_tensor(np.ascontiguousarray(prep.tpm, dtype=dtype),
                          device=dev)
    kwargs = nmf_kwargs or stages.nmf_run_params()
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    walls["prepare"] = wall(t0)

    t0 = time.perf_counter()
    spectra, n_iters = {}, {}
    for k in sorted(set(ks)):
        rows = [i for i, (kk, _) in enumerate(grid) if kk == k]
        t_k = time.perf_counter()
        spectra[k], n_it = stages.factorize_k(X_host, Xd, k, seeds[rows], kwargs)
        n_iters[k] = n_it
        if verbose:
            print(f"[factorize] k={k}: {len(rows)} restarts in "
                  f"{time.perf_counter() - t_k:.3f} s, sweeps max {n_it.max()} "
                  f"mean {n_it.mean():.1f}", flush=True)
    walls["factorize"] = wall(t0)

    t0 = time.perf_counter()
    merged = stages.combine_arrays(list(spectra[k_cons]))
    walls["combine"] = wall(t0)

    t0 = time.perf_counter()
    result = stages.consensus_arrays(merged, k_cons, Xd, tpm, prep.tpm_std,
                                     prep.hvg_idx, kwargs,
                                     density_threshold=0.5)
    walls["consensus"] = wall(t0)
    return walls, merged, result, n_iters


def run_cnmf(counts, ks, n_iter, hvg, k_cons, workdir):
    """The same four stages through cNMF(device="cuda") and its files."""
    import pandas as pd
    import torch

    from cnmf_tpu_torch import cNMF
    from cnmf_tpu_torch.io.dataframe import load_df_from_npz, save_df_to_npz

    counts_fn = os.path.join(workdir, "counts.df.npz")
    save_df_to_npz(pd.DataFrame(
        counts, index=[f"cell{i}" for i in range(counts.shape[0])],
        columns=[f"gene{j}" for j in range(counts.shape[1])],
    ), counts_fn)
    obj = cNMF(output_dir=workdir, name="smoke", device="cuda")
    walls = {}
    for stage, call in (
        ("prepare", lambda: obj.prepare(counts_fn=counts_fn, components=ks,
                                        n_iter=n_iter, seed=14,
                                        num_highvar_genes=hvg)),
        ("factorize", lambda: obj.factorize(verbose=True)),
        ("combine", lambda: obj.combine()),
        ("consensus", lambda: obj.consensus(k=k_cons, density_threshold=0.5,
                                            show_clustering=False)),
    ):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls[stage] = time.perf_counter() - t0
    usage, *_ = obj.load_results(K=k_cons, density_threshold=0.5)
    for key in ("consensus_spectra", "consensus_usages", "gene_spectra_tpm",
                "gene_spectra_score", "starcat_spectra"):
        frame = load_df_from_npz(obj.paths[key] % (k_cons, "0_5"))
        assert np.isfinite(frame.values).all(), key
    return walls, usage.values


def phase_profile(counts, hvg, dev, card, ks, n_iter, profile_ks,
                  nmf_kwargs=None, label="CD"):
    """The K of ``profile_ks`` factorized again under torch.profiler: the
    device-busy time of the run, its idle share, and the ops that take most
    of the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    Xd = torch.as_tensor(X_host, device=dev)
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    kwargs = nmf_kwargs or stages.nmf_run_params()
    for k in profile_ks:
        rows = [i for i, (kk, _) in enumerate(grid) if kk == k]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, n_it = stages.factorize_k(X_host, Xd, k, seeds[rows], kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = sorted(
            ((e.self_device_time_total / 1e6, e.key)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
            reverse=True)
        busy = sum(s for s, _ in events)
        assert busy > 0, "the profiler saw no device time"
        top = "; ".join(f"{key[:48]} {s:.3f} s" for s, key in events[:4])
        print(f"[profile] {label} factorize k={k}, {len(rows)} restarts, sweeps max "
              f"{n_it.max()}: wall {wall:.3f} s (profiled), device busy "
              f"{busy:.3f} s, idle share {1 - busy / wall:.2%}; top device "
              f"ops: {top}; card: {card}", flush=True)


def phase_small_agreement(dev, nmf_kwargs=None, label="frobenius"):
    """The slice at the verify recipe's size (300×400 counts, K=5,6 × 5
    restarts, 200 HVGs, consensus K=6), f32 on the card and on the CPU: the
    consensus artifacts must agree within the repo's SSE contract. Also
    prints whether each restart took as many sweeps on both."""
    rng = np.random.RandomState(42)
    W = rng.gamma(0.7, 1.0, size=(300, 6))
    H = rng.gamma(0.5, 1.0, size=(6, 400)) * (rng.rand(6, 400) < 0.3)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(1) == 0, 0] = 1
    _, merged_gpu, gpu, it_gpu = run_stages(X, [5, 6], 5, 200, 6, dev,
                                            nmf_kwargs=nmf_kwargs)
    _, merged_cpu, cpu, it_cpu = run_stages(X, [5, 6], 5, 200, 6, "cpu",
                                            nmf_kwargs=nmf_kwargs)
    merged_diff = float(np.abs(merged_gpu - merged_cpu).max()
                        / np.abs(merged_cpu).max())
    sse = {name: float(((getattr(gpu, name) - getattr(cpu, name)) ** 2).sum()
                       / (getattr(cpu, name) ** 2).sum())
           for name in ("spectra", "usages", "spectra_tpm", "spectra_score")}
    sweeps = {k: (it_gpu[k].tolist(), it_cpu[k].tolist()) for k in it_gpu}
    print(f"[small] {label}, card vs CPU at 300x400, K=6: merged spectra max "
          f"rel diff {merged_diff:.3e}; consensus relative SSE {sse} (bound "
          f"{SMALL_SSE_BOUND:g}); sweeps per restart (card, CPU) {sweeps}",
          flush=True)
    assert max(sse.values()) < SMALL_SSE_BOUND, sse


def check_result(result, k, hvg):
    """Finite consensus arrays of the expected shapes at the 2700x10000
    size; returns the usages normalized to rows summing to 1."""
    for name in ("spectra", "usages", "spectra_tpm", "spectra_score"):
        assert np.isfinite(getattr(result, name)).all(), name
    assert result.spectra.shape == (k, hvg)
    assert result.usages.shape == (2700, k)
    assert result.spectra_tpm.shape == (k, 10000)
    return result.usages / result.usages.sum(axis=1, keepdims=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()

    # 1. environment
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "h5py", "yaml", "matplotlib")}
    print(f"[env] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}; "
          f"packages: {have}", flush=True)

    # 2. build
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.ops.kernel_lib import load_library
    from cnmf_tpu_torch.pipeline import stages

    t0 = time.perf_counter()
    lib = load_library()
    build_s = time.perf_counter() - t0
    with open(lib.so_path + ".log") as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    print(f"[build] {os.path.relpath(lib.so_path)} in {build_s:.2f} s; "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    # 3. kernels against plain, then the small slice against the CPU
    records = phase_kernels(dev, card)
    records.update(phase_mu_kernels(dev, card))
    kl_kwargs = stages.nmf_run_params(beta_loss="kullback-leibler",
                                      max_iter=200)
    phase_small_agreement(dev)
    phase_small_agreement(dev, kl_kwargs, "kullback-leibler")

    # 4. the main path at PBMC-3k scale
    ks, n_iter, hvg, k_cons = list(range(5, 14)), 100, 2000, 10
    counts = make_counts(2700, 10000)
    wrappers = {"cd_w_half_sweep": ck.cd_w_half_sweep,
                "cd_h_half_sweep": ck.cd_h_half_sweep,
                "cd_sweep_from_products": ck.cd_sweep_from_products}
    for fn in wrappers.values():
        fn.launches = 0
    missing = [m for m in ("pandas", "h5py", "yaml") if not have[m]]
    if not missing:
        route = "cNMF(device='cuda') with its run directory"
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
            walls, usage = run_cnmf(counts, ks, n_iter, hvg, k_cons, workdir)
    else:
        route = (f"pipeline/stages.py on arrays ({', '.join(missing)} missing, "
                 "which cNMF's run directory needs)")
        walls, _, result, _ = run_stages(counts, ks, n_iter, hvg, k_cons, dev,
                                         verbose=True)
        usage = check_result(result, k_cons, hvg)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    assert np.allclose(usage.sum(axis=1), 1.0), "usage rows must sum to 1"
    print(f"[slice] 2700x10000 counts, {hvg} HVGs, K={ks[0]}..{ks[-1]} x "
          f"{n_iter} restarts, consensus K={k_cons} dt 0.5, via {route}: "
          "walls_s " + json.dumps({k: round(v, 3) for k, v in walls.items()})
          + f"; launches {launches}; card: {card}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    phase_profile(counts, hvg, dev, card, ks, n_iter, (min(ks), max(ks)))

    # 5. the KL path at bench.py's KL configuration
    mu_wrappers = {name: getattr(mk, name) for name in MU_KERNELS}
    for fn in mu_wrappers.values():
        fn.launches = 0
    walls, _, result, n_iters = run_stages(counts, [k_cons], n_iter, hvg,
                                           k_cons, dev, verbose=True,
                                           nmf_kwargs=kl_kwargs)
    mu_launches = {name: fn.launches for name, fn in mu_wrappers.items()}
    usage = check_result(result, k_cons, hvg)
    assert np.allclose(usage.sum(axis=1), 1.0), "usage rows must sum to 1"
    its = n_iters[k_cons]
    print(f"[kl-slice] 2700x10000 counts, {hvg} HVGs, K={k_cons} x {n_iter} "
          f"restarts, beta_loss=kullback-leibler, max_iter 200, consensus "
          f"K={k_cons} dt 0.5, via pipeline/stages.py: walls_s "
          + json.dumps({k: round(v, 3) for k, v in walls.items()})
          + f"; iterations max {its.max()} mean {its.mean():.1f}; launches "
          f"{mu_launches}; card: {card}", flush=True)
    assert all(n > 0 for n in mu_launches.values()), mu_launches
    launches.update(mu_launches)
    phase_profile(counts, hvg, dev, card, [k_cons], n_iter, [k_cons],
                  kl_kwargs, "KL")

    # 6. results
    replaces = {"cd_w_half_sweep": "cnmf_tpu/ops/pallas_cd.py:118",
                "cd_h_half_sweep": "cnmf_tpu/ops/pallas_cd.py:162",
                "cd_sweep_from_products": "cnmf_tpu/ops/pallas_cd.py:58",
                "kl_mu_w_numerator": "cnmf_tpu/ops/pallas_mu.py:89",
                "kl_mu_h_numerator": "cnmf_tpu/ops/pallas_mu.py:394",
                "kl_x_log_wh": "cnmf_tpu/ops/pallas_mu.py:357"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source="cnmf_tpu_torch/csrc/" + (
                 "mu_kl.cu" if name in MU_KERNELS else "cd_half_sweep.cu"),
             replaces=replaces[name], launches=launches[name], **rec)
        for name, rec in records.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
