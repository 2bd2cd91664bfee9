#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cnmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s):

1. environment: the card's name and power limit, torch/CUDA versions, and
   which of pandas, h5py, yaml and matplotlib are missing;
2. build: every kernel of csrc/ into one library, started on a background
   thread by cNMF's autowarm (as factorize starts it) while the main path's
   counts are drawn, the first launch waiting for it (build seconds; ptxas
   lines of the kernel families' registers: one line for the families
   without a stack frame or spill, one for each other family with the
   builds that keep a stack frame or spill);
3. each kernel against its plain PyTorch version on the card (max relative
   difference, f32, bounded by KERNEL_REL_BOUND), with median times at the
   main path's shapes: the CD half-sweeps (K=8 and K=16 buckets, each with
   the time of its data product alone as one flat matmul, its share of the
   bound and the fused kernel's grid: blocks, restarts per block, waves on
   the card's SMs; ragged cases with B off the restart groups; the
   products-given sweep at the TPM-spectra refit's shape, per wrapper call
   and its kernel alone), the KL multiplicative-update kernels and the
   general-beta kernels (at beta 0 and 1.5) at the factorize shape (K=16,
   and K=8 with zero columns), the W terms and the KL divergence at the
   consensus refits' two shapes (each with its share of the bound and its
   kernel's grid: its tiling, or how the contraction is split); then ragged
   shapes at every K bucket 8..64 and at the wide K 72 and 136 of every
   entry point, one line for the CD kernels and one for the MU kernels,
   each entry point's worst case and count (each case asserts the bound,
   and that zero K columns stay exactly zero; the general-beta and
   divergence entries count the kernel each case ran, and every one of
   them must have run
   (MU_COVER): whole and split at every bucket, restart-tiled with a
   partial restart group, wide); then the slice at the verify recipe's size
   on the card against the same code on the CPU (both drawing their inits
   and kmeans++ seeds on the host), with the frobenius (CD),
   the kullback-leibler and the itakura-saito (MU) loss, the K-selection
   stats of K=5 and 6 included;
4. the main path end to end at PBMC-3k scale — bench.py's make_counts(2700,
   10000), 2000 HVGs, K=5..13 × 100 restarts, consensus at K=10 (density
   threshold 0.5) — through cNMF(device="cuda") when pandas, h5py and yaml
   import, else through the same stages in pipeline/stages.py, on the
   default schedule (factorize draws the random inits on the card and runs
   the device ladder; consensus seeds its KMeans on the card): stage walls
   and the CD kernels' launch counts, each of which must be > 0 (each K's
   wall, sweeps and executed restart-sweeps are on the ``[schedule]`` line
   of 7.);
5. k-selection over that run's merged spectra of K=5..13: silhouette,
   prediction error and wall of each K, and the products kernel's launches;
   then ``[fused]``: consensus at K=10 on the same merged spectra as one
   program on the card (the default, ops/consensus_fused.py) and step by
   step (CNMF_TPU_FUSED_CONSENSUS=0's path) in paired turns: equal labels,
   every artifact within FUSED_SSE, the walls, and the synchronizing calls
   of each (torch.cuda.set_sync_debug_mode): the one program's must be the
   Lloyd and refit loops' block checks and one drain; and ``[device-tpm]``:
   the compact integer TPM (ops/device_tpm.py) on the slice's counts —
   the bytes of each upload, the device TPM against the host's (≤ 3e-7
   relative), the CSR image and the one-pass derive bit-equal, and the CD
   factorize of every K with and without the TPM prefetch beside it, in
   paired turns; and ``[drain]`` (phase_drain): the grid again through
   stages.factorize_grid, the grid cNMF.factorize runs (the spectra packed on
   the card and fetched in one copy, npz files written from a pool), bit
   for bit the per-K path's, its copies, bytes and phase split, and the
   packed tensor's twin feeding consensus and the k-selection sweep
   against the host spectra (both timed in paired turns, consensus beside
   a busy writer and an idle one), then the grid with a cNMF's deferred
   drain (the CLI's default on a card): consensus on the stack memo's
   twin while the writer lands the copy, the landed bits after the flush;
6. the threefry-seeded paths (``[seeded]``, phase_seeded): the card's
   draw against the CPU's (bits and uniforms equal, the normals' largest
   gap in ulps), the CD factorize of every K with the inits drawn on the
   card and with the host's, in paired turns (wall, seconds until the
   inits lie on the card, sweeps; the host's seconds at K=13 taken apart),
   the seeded restart axis on two shards of the card bit-equal to one
   device, the seeded cell axis (consensus within MESH_SSE), and consensus
   with kmeans++ on the card against the host's (relative SSE); then the
   mesh (``[mesh]``) from the host's inits and kmeans++ seeding
   (HOST_DRAWS): the sharded paths as two shards on the card, a mesh of
   the same card twice (no multi-card speed): (a) the restart axis, the CD
   factorize at every K of the main path (the host-drawn single-device
   spectra of ``[seeded]`` bit for bit and their sweeps) and the KL
   factorize (the same
   sweeps, consensus within MESH_SSE of the single device's); (b) the cell
   axis at K=10, CD, KL and Itakura-Saito (consensus within MESH_SSE), with
   cd_sweep_from_products held against plain at the cell axis' H half
   (B=100, M=2000, K=16) and the time of the shards' partial products and
   of their sum; (c) consensus on cell-sharded normalized counts and TPM
   (within MESH_SSE); (d), run in the atlas phase, the forced atlas
   consensus with its products-given solves row-sharded over the two
   shards (within MESH_ATLAS_SSE of the unsharded forced run, with more
   products launches than it). The mesh kernels' launches are counted over
   the mesh runs of (a)-(c) alone, each must be > 0; then every kernel
   they launch is held against plain at a shard's shapes (the cell axis'
   1,350 rows, a restart group's first ladder rung);
7. the CD factorize of every K again with the plain solver and on the
   device ladder, in paired turns, on one line: per K its walls, sweeps,
   executed restart-sweeps and idle shares (torch.profiler); the ladder
   must give the plain solver's n_iter and, as the CUDA default, its bits;
   then the kernels each ladder rung takes at the MU slices' bucket, and
   the batch check: every launch of a step gives a restart the same bits on
   100 of 104 restarts in place and on 56, 32 or 16 of them shuffled as
   inside the 104, at every bucket 8..64; then ``[sched]``
   (phase_sched): the grid through stages.factorize_grid on the staged,
   merged-grid and compacted schedules against the default per-K path,
   n_iter equal at every restart and the spectra's bits (or, where the
   staged merge changes a restart's kernel bucket, consensus within
   SCHED_SSE), and the autowarm's timeline;
8. the KL path at bench.py's KL configuration — the same counts, K=10 × 100
   restarts with beta_loss="kullback-leibler" and at most 200 iterations,
   combine, consensus at K=10 — through pipeline/stages.py: stage walls,
   iterations and the KL kernels' launch counts, each of which must be > 0,
   and of those the launches with one restart (the B=1 refits); then its
   ``[fused]`` at K=10 as in 5.; its factorize plain and on the ladder, and
   its consensus (the stage of the B=1 refits) under torch.profiler;
9. the Itakura-Saito path, the same configuration with
   beta_loss="itakura-saito", k-stats at K=10 as well, and consensus at
   density threshold IS_DENSITY_THRESHOLD: stage walls, iterations, the
   local densities and the general-beta kernels' launches (> 0), those of
   the B=1 refits apart; ``[fused]``; its factorize plain and on the
   ladder, and
   its k-stats and consensus (the stages of the B=1 refits) under
   torch.profiler;
10. Preprocess with Harmony at a 4-sample study's size (4 batches of 5,000
   cells × 10,000 genes, tests/test_preprocess.py's recipe; 2,000 seurat_v3
   HVGs, PCA 50, Harmony's 100 clusters) through
   Preprocess(device="cuda").preprocess_for_cnmf, and again on the CPU:
   stage walls (HVG and scaling on the host; PCA, Harmony with its
   iterations and rounds, the MOE ridge on X on the card), the batch
   separation (must fall below PP_SEPARATION of the uncorrected), and the
   card-vs-CPU difference of the corrected matrix and of R (printed only);
   Harmony's starting clusters from each device's PCs (printed), and
   Harmony on the card's PCs on the CPU and again on the card: the same
   iterations, rounds within PP_ONE_ROUNDS, Z_corr within PP_ONE_Z_REL of
   max, the matched top cluster the same for PP_ONE_MATCHED of the cells,
   the card repeating its R;
   then cNMF on the corrected HVGs (TP10K as the TPM): K=10 × 20 restarts
   from nndsvd inits (host init seconds apart from the solve; the CD
   kernels' launches must be > 0), consensus at density threshold 0.5, and
   cNMF.refit_usage / refit_spectra against the solver calls they wrap
   (within PP_REFIT_REL; the products-given sweep must launch);
11. the atlas path (``[atlas]``): extras/atlas_validate.synthesize's
   recipe at its defaults, 100,000 cells × 20,000 genes at about 12 % fill,
   drawn on the card and kept as CSR on the host; prepare (2,000 HVGs, the
   TPM sparse on the host), K=12 × 30 restarts from the CSR, combine, and
   consensus at K=12 twice: with the TPM device-densified on the card, and
   forced over the device limit onto the host-SpMM products and the
   products-given kernel (the resident one as one program on the card,
   its peak device memory apart). Stage walls, the consensus sub-stages,
   device against host densify and upload of the TPM, peak device memory
   and the CD kernels' launches over the path; the forced artifacts must be
   within ATLAS_FORCED_SSE of the resident ones, the device densify
   bit-equal to the native host densify, the native library loaded, and the
   products-given kernel within its bound of plain at M=100,000 and 20,000;
12. a JSON line of the kernels (times, the bound of the work at the main
   shape, launches on the main path, the MU kernels' B=1 launches and the
   CD kernels' atlas-path launches and those of one one-program consensus
   of each slice apart, the refits' times, bounds and
   splits, the products-given kernel's atlas times), the card line, and the
   result line {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it runs and read just
after.

Nothing is caught: any failure exits non-zero before the result line. With
no CUDA device the script exits 2 and prints no result.
"""

import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_REL_BOUND = 1e-4   # max |kernel - plain| / max |plain|, f32
SMALL_SSE_BOUND = 1e-4    # the repo's consensus-artifact contract (SSE)
# K-selection stats, card against CPU, both f32: the silhouette's distances
# between near-identical spectra come from the f32 gram trick, whose
# rounding depends on the matmul's summation order
K_STATS_SIL_ABS = 1e-3
K_STATS_ERR_REL = 1e-4
# Itakura-Saito on these counts stops by sklearn's rule after 20 iterations
# and leaves no spectrum within 0.5 of its neighbours (local densities
# 0.54-0.70 on one H100), so its consensus keeps every spectrum: no two
# unit vectors are more than sqrt(2) apart
IS_DENSITY_THRESHOLD = 2.0
# the H100 SXM's data-sheet peaks at 700 W: f32 outside the tensor cores,
# and HBM3
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# the main path's two fused-kernel buckets: K=9..13 pad to 16, K=5..8 to 8
# (K=5 carries 3 zero columns)
MAIN = [(dict(B=100, N=2700, G=2000, K=16), 0),
        (dict(B=100, N=2700, G=2000, K=8), 3)]
REFIT = dict(B=1, M=10000, K=16)   # the consensus TPM-spectra refit
# ragged shapes (rows and contraction off the tile) at every register K
# bucket and two wide K, each with two zero K columns that must stay
# exactly zero: skipped (zero hessian) without regularization, live but
# pinned at 0 with it
REGS = dict(l1_reg=0.1, l2_reg=0.2)
# B=1, 13 and 17 put the restarts off the fused kernel's restart groups at
# the main path's buckets, with X's row pitch (G) not a multiple of 4
RAGGED = [(dict(B=7, N=1001, G=333, K=8), {}),
          (dict(B=1, N=301, G=133, K=8), REGS),
          (dict(B=13, N=522, G=97, K=8), {}),
          (dict(B=17, N=389, G=271, K=8), REGS),
          (dict(B=5, N=700, G=150, K=16), REGS),
          (dict(B=1, N=257, G=61, K=16), {}),
          (dict(B=13, N=301, G=129, K=16), REGS),
          (dict(B=17, N=450, G=333, K=16), {}),
          (dict(B=3, N=517, G=271, K=24), REGS),
          (dict(B=2, N=300, G=129, K=32), {}),
          (dict(B=3, N=450, G=77, K=40), REGS),
          (dict(B=2, N=333, G=90, K=48), {}),
          (dict(B=3, N=257, G=65, K=56), REGS),
          (dict(B=2, N=200, G=130, K=64), REGS),
          (dict(B=3, N=301, G=141, K=72), REGS),
          (dict(B=2, N=150, G=97, K=136), {})]
PAD_COLS = 2
# the MU factorize's buckets (K=10 pads to 16; K=8 with zero columns as a
# K=5 run pads), the consensus refits and ragged shapes at every bucket and
# the two wide K, with B not a multiple of 4 and N off the 128-row tile. The
# refits hold H fixed, so they run the W terms and the KL divergence only:
# the two usage refits on row-major X (2700 cells × 2000 HVGs), the spectra
# refit on X = TPMᵀ (10000 genes × 2700 cells, read as a transposed view)
MU_MAIN = [(dict(B=100, N=2700, G=2000, K=16), 0),
           (dict(B=100, N=2700, G=2000, K=8), 3)]
MU_REFIT = [(dict(B=1, N=2700, G=2000, K=16), "usage refit", False),
            (dict(B=1, N=10000, G=2700, K=16),
             "spectra refit (X^T view)", True)]
MU_RAGGED = [dict(B=3 + 2 * (i % 3), N=300 + 37 * i, G=150 + 29 * i, K=K)
             for i, K in enumerate(list(range(8, 65, 8)) + [72, 136])]
# general-beta and divergence-term cases the contraction is not split at
# (MU_RAGGED's split at every bucket): B=90 restarts of 3-5 row tiles keep
# the one-row kernel's grid at 2 waves or more on both sides at every
# register bucket, and the restart-tiled kernels' grids too small for them;
# B off their restart groups with X's pitch not a multiple of 4 on grids
# they take (a partial restart group, 4-byte staging)
MU_WHOLE = [dict(B=90, N=300 + 37 * i, G=260 + 29 * i, K=K)
            for i, K in enumerate(range(8, 65, 8))]
TILED_EDGE = [dict(B=97, N=2701, G=1999, K=16),
              dict(B=97, N=2701, G=1999, K=8)]
KL_NUMERATORS = ("kl_mu_w_numerator", "kl_mu_h_numerator")
KL_KERNELS = KL_NUMERATORS + ("kl_x_log_wh",)
BETA_KERNELS = ("beta_mu_w_terms", "beta_mu_h_terms")
BETAS = (0.0, 1.5)   # Itakura-Saito, and a beta that takes powf
MU_REFIT_KERNELS = ("kl_mu_w_numerator", "kl_x_log_wh", "beta_mu_w_terms")


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


def device_ms(fn, launches=50, reps=5):
    """Median milliseconds one call of ``fn`` keeps the device busy:
    ``launches`` calls queued behind a sleeping kernel, so that the host's
    time to enqueue them stays outside the events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(10_000_000)   # a few ms: longer than the enqueue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(kernel, plain):
    """(max abs error, max relative error) of kernel results against their
    plain versions (each result relative to its own largest value)."""
    abs_err, rel_err = 0.0, 0.0
    for a, b in zip(as_list(kernel), as_list(plain)):
        d = float((a - b).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.abs().max()), 1e-30))
    return abs_err, rel_err


def check_pad(out, pad):
    """Zero K columns of the inputs stay exactly zero in every (B, M, K)
    output (the violation and divergence vectors have none)."""
    for t in as_list(out):
        assert pad == 0 or t.ndim != 3 or not t[:, :, -pad:].any(), \
            "padding moved"


def bound(flops, nbytes):
    """(bound ms, what binds): the larger of the operations over the f32
    peak and the compulsory bytes over the HBM rate."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_work(name, X, B, N, G, K):
    """(operations, compulsory bytes) of one launch at these inputs, an FMA
    two operations and a division, reciprocal, power or log one. What the
    data decides is counted from X: the KL numerators need the
    reconstruction only where X is nonzero, the divergence term where X >
    eps; the general-beta denominator needs it everywhere."""
    nz = int((X != 0).sum())
    if name.startswith("cd_"):
        M, C = (N, G) if name == "cd_w_half_sweep" else (G, N)
        return (2 * M * C * K * B + 2 * M * K * K * B,
                4 * (M * C + 2 * B * M * K + B * C * K + B * K * K))
    if name in ("kl_mu_w_numerator", "kl_mu_h_numerator"):
        out = N if name == "kl_mu_w_numerator" else G
        return B * nz * (4 * K + 1), 4 * (N * G + B * (N + G) * K + B * out * K)
    if name == "kl_x_log_wh":
        gt = int((X > np.finfo(np.float32).eps).sum())
        return B * gt * (2 * K + 2), 4 * (N * G + B * (N + G) * K) + 8 * B
    out = N if name == "beta_mu_w_terms" else G
    return (B * (N * G * (4 * K + 1) + nz * (2 * K + 1)),
            4 * (N * G + B * (N + G) * K + 2 * B * out * K))


class RaggedLines:
    """Ragged cases folded into one line for a phase's kernels: for each
    entry point its cases (register buckets and wide K together), the
    kernels they ran, and the worst case; every case has asserted its bound
    before it is added."""

    def __init__(self):
        self.rows = {}

    def add(self, name, K, rel, abs_err, kind=None):
        """``kind``: the kernel the case ran, counted on the line."""
        r = self.rows.setdefault(name, dict(n=0, rel=0.0, abs=0.0, kinds={}))
        r["n"] += 1
        r["rel"], r["abs"] = max(r["rel"], rel), max(r["abs"], abs_err)
        if kind:
            r["kinds"][kind] = r["kinds"].get(kind, 0) + 1

    def print(self):
        def text(kinds):
            return ", ".join(f"{k} {n}" for k, n in kinds.items())

        # the kernels each case ran, once for the line when every entry
        # point that counts them ran the same ones
        kinds = {text(r["kinds"]) for r in self.rows.values() if r["kinds"]}
        shared = kinds.pop() if len(kinds) == 1 else None
        print("[kernel] ragged, K=8..64 and 72,136, zero K columns stay 0 "
              "(cases, worst max_rel_diff / max_abs_err"
              + (f"; * cases by kernel: {shared}" if shared else "")
              + "): " + "; ".join(
                  f"{name} {r['n']}" + ("*" if shared and r["kinds"] else
                                        f" ({text(r['kinds'])})"
                                        if r["kinds"] else "")
                  + f" {r['rel']:.3e} / {r['abs']:.3e}"
                  for name, r in self.rows.items()), flush=True)


def shape_text(shape):
    return " ".join(f"{key}={v}" for key, v in shape.items())


def main_record(records, name, K, abs_err, suffix="", **values):
    """The JSON line's values are the K=16 bucket's (suffix "" — at beta 0
    for the general-beta kernels), the others' beside them; the error is the
    worst of the main cases."""
    rec = records.setdefault(name, dict(max_abs_err=0.0))
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    suffix += "" if K == 16 else f"_k{K}"
    rec.update({key + suffix: v for key, v in values.items()})


def grid_text(tiling, B, M):
    """A launch's grid over B restarts and M output rows, from its kernel's
    tiling (rows a block owns, restarts, threads, blocks an SM holds, and
    for the general-beta kernels the contraction's splits and entries a
    split): its blocks and their waves of as many blocks as an SM holds."""
    import torch

    rows, rb, threads, per_sm, *split = tiling
    splits, per_split = split or (1, None)
    blocks = -(-M // rows) * -(-B // rb) * splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cut = f"split {splits} x {per_split} entries, " if splits > 1 else ""
    return (f"grid {cut}{blocks} blocks of {rb} restarts x {rows} rows, "
            f"{threads} threads, {per_sm}/SM, "
            f"{blocks / max(per_sm * sms, 1):.2f} waves")


def phase_kernels(dev):
    """The CD kernels against plain on the card; returns {name: record}."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops.kernel_lib import kernel_function, raise_on

    rng = np.random.RandomState(0)
    ragged_lines = RaggedLines()

    def factors(B, N, G, K, pad):
        # the scale of sklearn's random init: sqrt(mean(X) / K) · |N(0, 1)|
        avg = np.sqrt(1.0 / K)
        X = rng.gamma(1.0, 1.0, (N, G)).astype(np.float32)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        return [torch.as_tensor(a, device=dev) for a in (X, W, Ht)]

    records, folded = {}, []
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
            assert rel_err <= KERNEL_REL_BOUND, (name, tag, shape, rel_err)
            if tag == "ragged":
                ragged_lines.add(name, shape["K"], rel_err, abs_err)
                continue
            ms = timed_ms(lambda: kernel(X, W, Ht, **regs))
            plain_ms = timed_ms(lambda: plain(X, W, Ht, **regs))
            # the data product alone, one flat matmul: a yardstick for the
            # kernel's GEMM part (the port never calls it on CUDA)
            product_ms = timed_ms(
                (lambda: ck._shared_x_dot(X, Ht)) if name == "cd_w_half_sweep"
                else (lambda: ck._shared_xt_dot(X, W)))
            bound_ms, by = bound(*kernel_work(name, X.cpu().numpy(), **shape))
            transposed = name == "cd_h_half_sweep"
            grid = grid_text(ck.fused_tiling(shape["K"], transposed),
                             shape["B"], shape["G" if transposed else "N"])
            if shape["K"] != 16:
                # the other main bucket: one folded line below
                folded.append(f"{name} rel={rel_err:.1e} {ms:.4f}/"
                              f"{plain_ms:.4f}/{product_ms:.4f}/"
                              f"{bound_ms:.4f}")
            else:
                print(f"[kernel] {name} main {shape_text(shape)}: "
                      f"rel={rel_err:.3e} abs={abs_err:.3e} kernel_ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} product_ms={product_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} of_bound={bound_ms / ms:.1%}; "
                      f"{grid}", flush=True)
            main_record(records, name, shape["K"], abs_err, ms=ms,
                        plain_ms=plain_ms, product_ms=product_ms)
            if shape["K"] == 16:
                records[name]["bound_ms"], records[name]["bound_by"] = \
                    bound_ms, by

    (k8, pad8), = [(m, pad) for m, pad in MAIN if m["K"] != 16]
    print(f"[kernel] CD main {shape_text(k8)} K0={pad8} (kernel/plain/"
          "product/bound ms): " + "; ".join(folded), flush=True)

    name = "cd_sweep_from_products"
    cases = [(REFIT, "main", {})] + [
        (dict(B=r["B"], M=r["N"], K=r["K"]), "ragged", g) for r, g in RAGGED]
    for shape, tag, regs in cases:
        B, M, K = shape["B"], shape["M"], shape["K"]
        avg = np.sqrt(1.0 / K)
        F = (avg * np.abs(rng.randn(B, M, K))).astype(np.float32)
        Hfix = (avg * np.abs(rng.randn(B, 2700, K))).astype(np.float32)
        if tag == "ragged":
            F[:, :, -PAD_COLS:] = 0.0
            Hfix[:, :, -PAD_COLS:] = 0.0
        F, Hfix = (torch.as_tensor(a, device=dev) for a in (F, Hfix))
        gram = ck._gram(Hfix)
        P = torch.as_tensor(rng.gamma(1.0, 1.0, (B, M, K)).astype(np.float32),
                            device=dev) * gram.diagonal(dim1=1, dim2=2)[:, None]
        kernel, plain = ck.cd_sweep_from_products, ck.cd_sweep_from_products_plain
        out = kernel(F, gram, P, **regs)
        check_pad(out, PAD_COLS if tag == "ragged" else 0)
        abs_err, rel_err = compare(out, plain(F, gram, P, **regs))
        assert rel_err <= KERNEL_REL_BOUND, (name, tag, shape, rel_err)
        if tag == "ragged":
            ragged_lines.add(name, K, rel_err, abs_err)
            continue
        ms = timed_ms(lambda: kernel(F, gram, P, **regs))
        plain_ms = timed_ms(lambda: plain(F, gram, P, **regs))
        # the kernel alone, on buffers allocated once: what of the wrapper's
        # time the device takes
        out, part = torch.empty_like(F), torch.empty((M, B), device=dev)
        launch = kernel_function("cd_half_sweep_products", ck._PRODUCTS_ARGS)
        ptrs = (P.data_ptr(), M, F.data_ptr(), gram.data_ptr(), 0.0, B, K,
                out.data_ptr(), part.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        alone_ms = device_ms(lambda: raise_on(name, launch(*ptrs)))
        bound_ms, by = bound(2 * M * K * K * B, 4 * (3 * B * M * K + B * K * K))
        print(f"[kernel] {name} main {shape_text(shape)} {regs}: "
              f"rel={rel_err:.3e} abs={abs_err:.3e} "
              f"kernel_ms={ms:.4f} alone_ms={alone_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f}", flush=True)
        records[name] = dict(max_abs_err=abs_err, ms=ms, alone_ms=alone_ms,
                             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
    ragged_lines.print()
    return records


def kernel_kind(tiling, B, K):
    """Which kernel a general-beta or divergence-term launch of this tiling
    runs: "split" (the one-row kernel over slices of the contraction),
    "tiled" ("tiled partial" with a restart group B leaves part empty),
    "one-row" or "wide"."""
    _, restarts, _, _, splits, _ = tiling
    if splits > 1:
        return "split"
    if restarts > 1:
        return "tiled partial" if B % restarts else "tiled"
    return "wide" if K > 64 else "one-row"


# the kernels every general-beta entry point (each beta and side) and the
# divergence term must have run in the ragged and main cases: the one-row
# kernel whole and split at every register bucket, the restart-tiled kernel
# with a partial restart group and 4-byte staging at both of its buckets,
# and the wide variant
MU_COVER = ({("one-row", K) for K in range(8, 65, 8)}
            | {("split", K) for K in range(8, 65, 8)}
            | {("tiled partial", 8), ("tiled partial", 16),
               ("wide", 72), ("wide", 136)})
SPLIT_KERNELS = BETA_KERNELS + ("kl_x_log_wh",)   # the kernels MU_COVER holds


def phase_mu_kernels(dev):
    """The KL and general-beta multiplicative-update kernels against their
    plain versions on the card; returns {name: record}."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk

    rng = np.random.RandomState(1)
    ragged_lines = RaggedLines()

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
        return X, Xd, torch.as_tensor(W, device=dev), torch.as_tensor(Ht, device=dev)

    def runs(names, betas):
        """(name, beta or None, suffix) of each kernel call of a case."""
        for name in names:
            if name in BETA_KERNELS:
                for beta in betas:
                    yield name, beta, "" if beta == 0 else f"_b{beta:g}"
            else:
                yield name, None, ""

    records, folded = {}, []
    every = KL_KERNELS + BETA_KERNELS
    cases = ([(m, "main", pad, False, every, BETAS) for m, pad in MU_MAIN]
             + [(m, tag, 0, tr, MU_REFIT_KERNELS, (0.0,))
                for m, tag, tr in MU_REFIT]
             + [(r, "ragged", PAD_COLS, False, every, BETAS)
                for r in MU_RAGGED]
             + [(r, "ragged", PAD_COLS, False, SPLIT_KERNELS, BETAS)
                for r in MU_WHOLE + TILED_EDGE])
    covered = {}
    for shape, tag, pad, transposed, names, betas in cases:
        X_host, X, W, Ht = problem(**shape, pad=pad, transposed=transposed)
        for name, beta, suffix in runs(names, betas):
            kernel, plain = getattr(mk, name), getattr(mk, name + "_plain")
            args = (X, W, Ht) if beta is None else (X, W, Ht, beta)
            out = kernel(*args)
            check_pad(out, pad)
            abs_err, rel_err = compare(out, plain(*args))
            assert rel_err <= KERNEL_REL_BOUND, (name, beta, tag, shape, rel_err)
            h_side = name in ("kl_mu_h_numerator", "beta_mu_h_terms")
            label = name if beta is None else f"{name}(beta={beta:g})"
            if name in BETA_KERNELS:
                tiling = mk.beta_terms_tiling(X, Ht if h_side else W, beta,
                                              h_side)
            elif name == "kl_x_log_wh":
                tiling = mk.kl_x_log_wh_tiling(X, shape["B"], shape["K"])
            else:
                tiling = mk.kl_numerator_tiling(X, shape["B"], shape["K"],
                                                h_side)
            kind = None
            if name in SPLIT_KERNELS:
                kind = kernel_kind(tiling, shape["B"], shape["K"])
                covered.setdefault(label, set()).add((kind, shape["K"]))
            if tag == "ragged":
                ragged_lines.add(label, shape["K"], rel_err, abs_err, kind)
                continue
            ms = timed_ms(lambda: kernel(*args))
            plain_ms = timed_ms(lambda: plain(*args))
            beta_txt = "" if beta is None else f" beta={beta:g}"
            bound_ms, by = bound(*kernel_work(name, X_host, **shape))
            if tag == "main" and shape["K"] != 16:
                # the other main bucket: one folded line below
                folded.append(f"{name}{beta_txt} rel={rel_err:.1e} "
                              f"{ms:.4f}/{plain_ms:.4f}/{bound_ms:.4f}")
            else:
                print(f"[kernel] {name}{beta_txt} {tag} {shape_text(shape)}"
                      f": rel={rel_err:.3e} abs={abs_err:.3e} "
                      f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} "
                      f"of_bound={bound_ms / ms:.1%}; " + grid_text(
                          tiling, shape["B"], shape["G" if h_side else "N"]),
                      flush=True)
            if tag == "main":
                main_record(records, name, shape["K"], abs_err, suffix,
                            ms=ms, plain_ms=plain_ms)
                if shape["K"] == 16 and suffix == "":
                    records[name]["bound_ms"], records[name]["bound_by"] = \
                        bound_ms, by
            else:
                refit = tag.split()[0]   # "usage" or "spectra"
                records[name].update({f"{refit}_refit_ms": ms,
                                      f"{refit}_refit_bound_ms": bound_ms})
                if name in SPLIT_KERNELS:
                    records[name][f"{refit}_refit_splits"] = tiling[4]
    (k8, pad8), = [(m, pad) for m, pad in MU_MAIN if m["K"] != 16]
    print(f"[kernel] MU main {shape_text(k8)} K0={pad8} (kernel/plain/bound "
          "ms): " + "; ".join(folded), flush=True)
    ragged_lines.print()
    for label, kinds in covered.items():
        assert MU_COVER <= kinds, (label, sorted(MU_COVER - kinds))
    print(f"[kernel] coverage: {len(covered)} entry points ran every kernel "
          "of MU_COVER", flush=True)
    return records


def phase_autowarm(dev):
    """The build as cNMF.factorize starts it (``cNMF._autowarm``: on a
    background thread), the main path's counts drawn meanwhile, then a
    first launch, which waits for the build. Returns (the counts, the
    timeline from the build's start, the build's seconds)."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops.kernel_lib import warm_times
    from cnmf_tpu_torch.pipeline.cnmf import cNMF

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
        cNMF(output_dir=workdir, name="warm", device=dev)._autowarm()
    counts = make_counts(2700, 10000)
    t_counts = time.perf_counter()
    ck.cd_w_half_sweep(torch.zeros(8, 8, device=dev),
                       torch.zeros(1, 8, 8, device=dev),
                       torch.ones(1, 8, 8, device=dev))
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    started, ended = warm_times()
    warm = (f"started 0.000, counts drawn {t_counts - started:.3f}, built "
            f"{ended - started:.3f}, first launch returned "
            f"{t_first - started:.3f}")
    assert started < t_counts and ended <= t_first, warm
    return counts, warm, ended - started


def make_counts(n_cells, n_genes, seed=7):
    from bench import make_counts as bench_counts

    return bench_counts(n_cells, n_genes, seed=seed)


def run_stages(counts, ks, n_iter, hvg, k_cons, dev, dtype=np.float32,
               nmf_kwargs=None, k_stats=(), density_threshold=0.5):
    """prepare → factorize → combine → [k-stats] → consensus through
    pipeline/stages.py with ``nmf_kwargs`` (default: stages.nmf_run_params(),
    frobenius); ``k_stats``: the K whose K-selection stats run. Returns
    (stage walls after a device synchronize, {K: merged spectra}, consensus
    result, {K: sweeps of each restart}, the normalized counts tensor, the
    k-stats rows)."""
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
        spectra[k], n_iters[k], _ = stages.factorize_k(X_host, Xd, k,
                                                       seeds[rows], kwargs)
    walls["factorize"] = wall(t0)

    t0 = time.perf_counter()
    merged = {k: stages.combine_arrays(list(s)) for k, s in spectra.items()}
    walls["combine"] = wall(t0)

    k_rows = []
    if k_stats:
        t0 = time.perf_counter()
        k_rows = stages.k_stats_arrays({k: merged[k] for k in k_stats}, Xd,
                                       kwargs)
        walls["k_stats"] = wall(t0)

    t0 = time.perf_counter()
    result = stages.consensus_arrays(merged[k_cons], k_cons, Xd, tpm,
                                     prep.tpm_std, prep.hvg_idx, kwargs,
                                     density_threshold=density_threshold)
    walls["consensus"] = wall(t0)
    return walls, merged, result, n_iters, Xd, k_rows


def run_cnmf(counts, ks, n_iter, hvg, k_cons, workdir):
    """The same four stages through cNMF(device="cuda") and its files;
    returns (walls, usages, {K: merged spectra}, normalized counts tensor)."""
    import pandas as pd
    import torch

    from cnmf_tpu_torch import cNMF
    from cnmf_tpu_torch.io.dataframe import load_df_from_npz, save_df_to_npz
    from cnmf_tpu_torch.io.h5ad import read_h5ad

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
    merged = {k: load_df_from_npz(obj.paths["merged_spectra"] % k).values
              for k in ks}
    Xd = obj._to_device_dense(read_h5ad(obj.paths["normalized_counts"]).X)
    return walls, usage.values, merged, Xd


def profiled(fn, n_top=4):
    """fn() under torch.profiler, synchronized: (its result, wall seconds,
    device-busy seconds, the n_top ops that take most of the device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(
        ((e.self_device_time_total / 1e6, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True)
    busy = sum(s for s, _ in events)
    assert busy > 0, "the profiler saw no device time"
    top = "; ".join(f"{key[:40]} {s:.3f} s" for s, key in events[:n_top])
    return out, wall, busy, top


def path_input(counts, hvg, dev):
    """(X on the host, X on the card): the slice's normalized counts, f32."""
    import torch

    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    return X_host, torch.as_tensor(X_host, device=dev)


def phase_schedules(X_host, Xd, ks, n_iter, kwargs, label):
    """Every K of ``ks`` (n_iter restarts each) factorized with the plain
    batched solver and on the device ladder, in paired turns (plain, ladder,
    ladder, plain): per K the mean wall of the two turns (synchronized),
    sweeps max / mean, the restart-sweeps the device executed and the idle
    share (1 - device busy / wall of a third, profiled run); per schedule
    each turn's total wall. Each schedule's two turns must give the same
    bits; the ladder must give the plain solver's n_iter at every restart,
    and, as the CUDA default, its spectra's bits. Returns {"plain" |
    "ladder": {K: spectra}}."""
    import torch

    from cnmf_tpu_torch.pipeline import stages
    from cnmf_tpu_torch.pipeline.solvers import device_ladder_enabled

    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    runs = {"plain": {}, "ladder": {}}
    for k in ks:
        k_seeds = seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]]
        for name in ("plain", "ladder", "ladder", "plain"):
            def run():
                return stages.factorize_k(X_host, Xd, k, k_seeds, kwargs,
                                          ladder=name == "ladder")

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spec, n_it, executed = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row = runs[name].get(k)
            if row is None:
                _, wall_p, busy, _ = profiled(run, n_top=0)
                runs[name][k] = dict(spec=spec, n=n_it, walls=[wall],
                                     busy=busy, wall_p=wall_p,
                                     executed=executed)
            else:
                assert (np.array_equal(spec, row["spec"])
                        and np.array_equal(n_it, row["n"])), (label, name, k)
                row["walls"].append(wall)
    plain, lad = runs["plain"], runs["ladder"]

    def idle(r):
        return 100 * (1 - r["busy"] / r["wall_p"])

    parts = [f"{k}: {np.mean(plain[k]['walls']):.3f}/"
             f"{np.mean(lad[k]['walls']):.3f}s {lad[k]['n'].max()}/"
             f"{lad[k]['n'].mean():.1f} {plain[k]['executed']}/"
             f"{lad[k]['executed']} {idle(plain[k]):.1f}/{idle(lad[k]):.1f}%"
             for k in ks]
    totals = "; ".join(
        f"{name} turns " + "+".join(
            f"{sum(r['walls'][i] for r in rows.values()):.3f}"
            for i in range(2))
        + f" s, {sum(r['executed'] for r in rows.values())} restart-sweeps, "
        f"busy {sum(r['busy'] for r in rows.values()):.3f} s"
        for name, rows in runs.items())
    same_n = all(np.array_equal(lad[k]["n"], plain[k]["n"]) for k in ks)
    diff = max(float(np.abs(lad[k]["spec"] - plain[k]["spec"]).max())
               for k in ks)
    default = device_ladder_enabled(Xd)
    print(f"[schedule] {label} plain/ladder (K: walls, sweeps max/mean, "
          "executed restart-sweeps, idle shares) " + "; ".join(parts)
          + f"; {totals}; same n_iter at every restart: {same_n}, spectra "
          f"max |diff| {diff:.3e}; ladder the CUDA default: {default}",
          flush=True)
    assert not default or (same_n and diff == 0.0), (label, same_n, diff)
    return {name: {k: r["spec"] for k, r in rows.items()}
            for name, rows in runs.items()}


def ulps(a, b):
    """Largest |a - b| in ulps of b (numpy arrays of one float dtype)."""
    return float(np.max(np.abs(a - b) / np.spacing(np.abs(b).astype(b.dtype))))


def phase_seeded(dev, counts, hvg, ks, n_iter, k_cons):
    """The threefry-seeded paths (``[seeded]``): (a) the card's draw of the
    main path's restarts (their keys, bits and f32 uniforms, and the
    normals of their W and Ht at K=16) against the CPU's: bits and
    uniforms equal, the normals' largest gap in ulps; (b) the main path's
    CD factorize (K=5..13 × 100 restarts) on the ladder with the inits
    drawn on the card (the CUDA default) and with sklearn's host draw, in
    paired turns (seeded, host, host, seeded): per arm the wall, the
    seconds until the inits lay on the card (host draw, padding and upload;
    or the card's draw), sweeps and executed restart-sweeps, each arm's two
    turns bit-equal, and the CD kernels' launches over one seeded turn
    (each > 0); the host arm's seconds at K=13 taken apart (draw, pad,
    upload) beside the card's draw; (c) the seeded restart axis on
    MESH_SHARDS shards of the card at every K, bit-equal to the seeded
    single device with its sweeps, and the seeded cell axis at k_cons,
    its consensus within MESH_SSE of the single device's; (d) consensus
    at k_cons with the kmeans++ seeding on the card against the host's:
    the relative SSE of each artifact (printed; the CPU tests hold the
    device seeding to the JAX package's). Returns the host arm (spectra and
    sweeps by K, walls), phase_mesh's single-device reference."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import prng
    from cnmf_tpu_torch.parallel.mesh import build_mesh
    from cnmf_tpu_torch.pipeline import stages

    def wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    Xd = torch.as_tensor(X_host, device=dev)
    tpm = torch.as_tensor(np.ascontiguousarray(prep.tpm, dtype=np.float32),
                          device=dev)
    cd = stages.nmf_run_params()
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    seeds_k = {k: seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]]
               for k in ks}

    # (a) the card's draw against the CPU's
    N, G = X_host.shape
    keys = prng.split(prng.prng_key(seeds_k[k_cons].astype(np.uint32)))
    draws = {}
    for where in ("cpu", dev):
        kk = keys.to(where)
        draws[str(where)] = dict(
            keys=kk.cpu(), bits=prng.random_bits(kk[:, 0], (G, 16)).cpu(),
            uniform=prng.uniform(kk[:, 1], (N, 16)).cpu(),
            Ht=prng.normal(kk[:, 0], (G, 16)).cpu().numpy(),
            W=prng.normal(kk[:, 1], (N, 16)).cpu().numpy())
    cpu, card_draw = draws["cpu"], draws[str(dev)]
    same = {name: bool(torch.equal(cpu[name], card_draw[name]))
            for name in ("keys", "bits", "uniform")}
    gap = {name: ulps(card_draw[name], cpu[name]) for name in ("W", "Ht")}
    unequal = float(np.mean(np.concatenate([
        (card_draw[n] != cpu[n]).ravel() for n in ("W", "Ht")])))
    draw_text = (f"draw of {len(keys)} restarts (W {N}x16, Ht {G}x16, f32) "
                 "card vs CPU: keys/bits/uniform equal "
                 + "/".join(str(v) for v in same.values())
                 + "; normals max gap ulps W/Ht "
                 + "/".join(f"{v:g}" for v in gap.values())
                 + f", unequal {unequal:.2e}")
    assert all(same.values()), same

    # (b) the main path's factorize, seeded against host-drawn, in turns
    wrappers = {"cd_w_half_sweep": ck.cd_w_half_sweep,
                "cd_h_half_sweep": ck.cd_h_half_sweep}
    arms = {}
    for arm in ("seeded", "host", "host", "seeded"):
        if arm == "seeded" and arm not in arms:
            for fn in wrappers.values():
                fn.launches = 0
        timings, spectra, sweeps, executed = {}, {}, {}, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in ks:
            spectra[k], sweeps[k], ex = stages.factorize_k(
                X_host, Xd, k, seeds_k[k], cd, timings=timings,
                device_init=arm == "seeded")
            executed += ex
        w = wall(t0)
        if arm in arms:
            assert all(np.array_equal(spectra[k], arms[arm]["spectra"][k])
                       for k in ks), arm
            arms[arm]["walls"].append(w)
            arms[arm]["init"].append(timings["init"])
            continue
        if arm == "seeded":
            launches = {n: fn.launches for n, fn in wrappers.items()}
        every = np.concatenate(list(sweeps.values()))
        arms[arm] = dict(spectra=spectra, sweeps=sweeps, walls=[w],
                         init=[timings["init"]],
                         text=f"{every.max()}/{every.mean():.1f} {executed}")
    assert all(n > 0 for n in launches.values()), launches
    # bottleneck 1 taken apart at K=13: host draw, pad, upload; card draw
    k, parts = ks[-1], {}
    t0 = time.perf_counter()
    W0, Ht0 = stages.restart_inits(X_host, k, seeds_k[k], "random",
                                   np.float32)
    parts["host_draw"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pad = ((0, 0), (0, 0), (0, ck.pad_bucket(k) - k))
    W0, Ht0 = np.pad(W0, pad), np.pad(Ht0, pad)
    parts["pad"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.factors_from_numpy(W0, Ht0, device=dev, dtype=np.float32)
    parts["upload"] = wall(t0)
    t0 = time.perf_counter()
    stages.restart_factors(X_host, Xd, k, seeds_k[k], "random", 16,
                           {"init": 0.0}, True,
                           stages.x_mean_for_init(X_host, np.float32))
    parts["card_draw"] = wall(t0)
    print(f"[seeded] {draw_text}. CD K={ks[0]}..{ks[-1]} x {n_iter}, turns "
          "seeded/host/host/seeded (wall s, init s, sweeps max/mean, "
          "restart-sweeps) " + "; ".join(
              f"{arm}: {'+'.join(f'{v:.3f}' for v in r['walls'])}, "
              f"{'+'.join(f'{v:.3f}' for v in r['init'])}, {r['text']}"
              for arm, r in arms.items())
          + f"; K={k} init s " + json.dumps(
              {n: float(f"{v:.4g}") for n, v in parts.items()},
              separators=(",", ":"))
          + f"; seeded launches W/H {launches['cd_w_half_sweep']}/"
          f"{launches['cd_h_half_sweep']}", flush=True)

    # (c) the seeded restart axis and cell axis on two shards of the card
    devices = [dev] * MESH_SHARDS
    restart_mesh = build_mesh(devices, cell_axis=1)
    t0 = time.perf_counter()
    same_bits = True
    for k in ks:
        spec, n_it, _ = stages.factorize_k(X_host, Xd, k, seeds_k[k], cd,
                                           mesh=restart_mesh,
                                           device_init=True)
        same_bits &= bool(np.array_equal(spec, arms["seeded"]["spectra"][k])
                          and np.array_equal(n_it, arms["seeded"]["sweeps"][k]))
    restart_s = wall(t0)
    t0 = time.perf_counter()
    cell_spec, _, _ = stages.factorize_k(
        X_host, Xd, k_cons, seeds_k[k_cons], cd,
        mesh=build_mesh(devices, cell_axis=MESH_SHARDS), device_init=True)
    cell_s = wall(t0)

    def consensus(spec, **kw):
        return stages.consensus_arrays(
            stages.combine_arrays(list(spec)), k_cons, Xd, tpm,
            prep.tpm_std, prep.hvg_idx, cd, density_threshold=0.5, **kw)

    one = consensus(arms["seeded"]["spectra"][k_cons])
    cell_gap = consensus_gap(consensus(cell_spec), one)
    assert same_bits and cell_gap <= MESH_SSE, (same_bits, cell_gap)

    # (d) consensus with the kmeans++ seeding on the card against the host's
    runs = {}
    for seeding in (True, False):
        t0 = time.perf_counter()
        runs[seeding] = (consensus(arms["seeded"]["spectra"][k_cons],
                                   device_kmeanspp=seeding), wall(t0))
    names = ("spectra", "usages", "spectra_tpm", "spectra_score")
    sse = {n: rel_sse(getattr(runs[True][0], n), getattr(runs[False][0], n))
           for n in names}
    assert all(np.isfinite(getattr(runs[True][0], n)).all() for n in names)
    print(f"[seeded] restart axis on {MESH_SHARDS} shards, K={ks[0]}.."
          f"{ks[-1]}: {restart_s:.3f} s, one device's bits and sweeps: "
          f"{same_bits}; cell axis K={k_cons}: {cell_s:.3f} s, consensus rel "
          f"SSE {cell_gap:.2e} (bound {MESH_SSE:g}). Consensus K={k_cons}, "
          f"kmeans++ on the card / host {runs[True][1]:.3f} / "
          f"{runs[False][1]:.3f} s, rel SSE spectra/usages/tpm/score "
          + "/".join(f"{v:.1e}" for v in sse.values()), flush=True)
    return arms["host"]


def phase_ladder_tilings(Xd, k):
    """The kernel each MU launch takes at each ladder rung at the KL and IS
    slices' bucket, and the rungs ``solvers.ladder_rungs`` keeps."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.ops.cd_kernels import pad_bucket
    from cnmf_tpu_torch.ops.nmf import _ladder
    from cnmf_tpu_torch.pipeline import stages
    from cnmf_tpu_torch.pipeline.solvers import ladder_rungs

    K, (N, G) = pad_bucket(k), Xd.shape
    parts = []
    for beta, loss in ((1.0, "kullback-leibler"), (0.0, "itakura-saito")):
        kinds = {}
        for B in _ladder(100, 16):
            W = torch.empty((B, N, K), device=Xd.device)
            Ht = torch.empty((B, G, K), device=Xd.device)
            if beta == 1:
                of = {"num W": "tiled" if mk.kl_numerator_tiling(Xd, B, K)[1]
                      > 1 else "one-row",
                      "num H": "tiled" if mk.kl_numerator_tiling(
                          Xd, B, K, True)[1] > 1 else "one-row",
                      "div": kernel_kind(mk.kl_x_log_wh_tiling(Xd, B, K), B, K)}
            else:
                of = {side: kernel_kind(mk.beta_terms_tiling(
                    Xd, F, beta, side == "H"), B, K)
                    for side, F in (("W", W), ("H", Ht))}
            for launch, kind in of.items():
                kinds.setdefault(launch, {}).setdefault(kind, []).append(B)
        kept = ladder_rungs(Xd, 100, K, stages.nmf_run_params(beta_loss=loss))
        parts.append(f"{'KL' if beta else 'IS'} K={K} " + "; ".join(
            f"{launch} " + ", ".join(f"{kind} at {'/'.join(map(str, Bs))}"
                                     for kind, Bs in by.items())
            for launch, by in kinds.items())
            + f" (rungs kept {'/'.join(map(str, kept))})")
    print("[ladder-tilings] " + " | ".join(parts),
          flush=True)


def phase_batch(dev):
    """Whether a restart's bits depend on the batch it shares, at every
    launch of a solver step on the device ladder: each wrapper,
    ``cd_kernels._gram``, the KL denominators and the KL and IS divergences
    (``nmf.beta_divergence_error``), each called on B of 104 restarts
    against the same restarts' rows of its call on all 104: B=100 in place
    (the plain solver's batch), and B each later rung of ``_ladder(100,
    16)``, drawn at random and shuffled, as the ladder's gathers leave them;
    at every register bucket 8..64 with the main path's X shape (2700 ×
    2000, 30 % zeros). A MU launch may differ only where its family's
    contraction splits (``mu_kernels.launch_splits``) at B otherwise than at
    104: ``solvers.ladder_rungs`` drops those rungs. Any other difference
    fails."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.ops.nmf import _ladder, beta_divergence_error

    g = torch.Generator(device="cpu").manual_seed(0)
    X = torch.rand(2700, 2000, generator=g)
    X = (X * (torch.rand(X.shape, generator=g) > 0.3)).to(dev)
    full, *rungs = _ladder(100, 16)
    launches = {
        "gram": (None, lambda X, W, Ht: (ck._gram(W), ck._gram(Ht))),
        "cd W": (None, ck.cd_w_half_sweep),
        "cd H": (None, ck.cd_h_half_sweep),
        "kl num W": (None, mk.kl_mu_w_numerator),
        "kl num H": (None, mk.kl_mu_h_numerator),
        "kl den": (None, lambda X, W, Ht: (mk.kl_w_denominator(Ht),
                                          mk.kl_h_denominator(W))),
        "kl div": (1.0, mk.kl_x_log_wh),
        "kl err": (1.0, lambda X, W, Ht: beta_divergence_error(X, W, Ht, 1.0)),
        "is err": (None, lambda X, W, Ht: beta_divergence_error(X, W, Ht,
                                                                0.0)),
        "beta0 W": (0.0, lambda X, W, Ht: mk.beta_mu_w_terms(X, W, Ht, 0.0)),
        "beta0 H": (0.0, lambda X, W, Ht: mk.beta_mu_h_terms(X, W, Ht, 0.0)),
    }
    same, split, other = 0, [], []
    for K in range(8, 65, 8):
        W = (torch.rand(full, 2700, K, generator=g) * 0.2).to(dev)
        Ht = (torch.rand(full, 2000, K, generator=g) * 0.2).to(dev)
        picks = [torch.arange(100)] + [torch.randperm(full, generator=g)[:B]
                                       for B in rungs]
        for name, (beta, fn) in launches.items():
            whole = fn(X, W, Ht)
            whole = whole if isinstance(whole, tuple) else (whole,)
            for idx in picks:
                B, idx = len(idx), idx.to(dev)
                part = fn(X, W[idx], Ht[idx])
                part = part if isinstance(part, tuple) else (part,)
                if all(torch.equal(a, b[idx]) for a, b in zip(part, whole)):
                    same += 1
                elif beta is not None and (mk.launch_splits(X, B, K, beta)
                                           != mk.launch_splits(X, full, K,
                                                               beta)):
                    split.append(f"{name} K={K} B={B}")
                else:
                    other.append(f"{name} K={K} B={B}")
        del W, Ht
    print(f"[batch] B of {full} restarts against their rows of the "
          f"{full}-restart call, B=100 in place and "
          f"{'/'.join(map(str, rungs))} shuffled, X 2700x2000 30% zeros, "
          f"K=8..64, {len(launches)} entry points: {same} same bits; "
          "differ where "
          f"the split differs (rung dropped): {', '.join(split) or 'none'}; "
          f"any other: {', '.join(other) or 'none'}",
          flush=True)
    assert not other, other


SCHED_KNOBS = ("CNMF_TPU_STAGED", "CNMF_TPU_GRID", "CNMF_TPU_COMPACT")
SCHED_SSE = 1e-4          # consensus on a schedule's spectra against per-K


def counted(wrappers, fn):
    """fn() with the launch counts of ``wrappers`` (name → wrapper) set to
    0 just before and read just after: (its result, {name: launches})."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def sched_grid(X_host, Xd, jobs, kwargs):
    """stages.factorize_grid on the schedule the environment picks:
    (synchronized wall, {K: spectra (B, k, G)}, {K: n_iter}, executed
    restart-sweeps, the CD half-sweeps' launches W/H)."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.pipeline import stages

    got = {}

    def write(k, iters, batch, dev):
        got[k] = np.array(batch)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps, launches = counted(
        {"cd_w_half_sweep": ck.cd_w_half_sweep,
         "cd_h_half_sweep": ck.cd_h_half_sweep},
        lambda: stages.factorize_grid(X_host, Xd, jobs, kwargs, write))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(n > 0 for n in launches.values()), launches
    return (wall, got, {k: n for k, (n, _) in sweeps.items()},
            sum(ex for _, ex in sweeps.values()), launches)


def phase_sched(counts, hvg, X_host, Xd, ks, n_iter, k_cons, warm):
    """``[sched]``: the CD main path's grid (``ks`` × ``n_iter`` restarts,
    inits drawn on the card) through stages.factorize_grid on each opt-in
    schedule (CNMF_TPU_STAGED=1, CNMF_TPU_GRID=1, CNMF_TPU_COMPACT=1)
    against the default per-K device ladder, run before and after them:
    synchronized walls, executed restart-sweeps, n_iter equal at every
    restart (asserted) and the spectra's max |diff|, which must be 0 for the
    grid and the compacted solve (their batches re-pack restarts within one
    K bucket, where ``[batch]`` holds the bits) and, where the staged merge
    moves a restart to another bucket's kernel and its bits differ, the
    consensus of K=10 and of the K that differs most within SCHED_SSE of
    the per-K one; then the autowarm's timeline (``warm``: seconds from its
    start)."""
    import torch

    from cnmf_tpu_torch.pipeline import stages

    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    jobs = [(k, seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]],
             np.arange(n_iter)) for k in ks]
    kwargs = stages.nmf_run_params()
    unset = dict.fromkeys(SCHED_KNOBS)
    with env_knobs(unset):
        ref = sched_grid(X_host, Xd, jobs, kwargs)
    runs, parts, differ = {}, [], {}
    launches = {name: 0 for name in ref[4]}
    for knob in SCHED_KNOBS:
        with env_knobs(dict(unset, **{knob: "1"})):
            runs[knob] = wall, spec, n_it, executed, n_launch = sched_grid(
                X_host, Xd, jobs, kwargs)
        same_n = all(np.array_equal(n_it[k], ref[2][k]) for k in ks)
        diffs = {k: float(np.abs(spec[k] - ref[1][k]).max()) for k in ks}
        name = knob.split("_")[-1].lower()
        for key, n in n_launch.items():
            launches[key] += n
        parts.append(f"{name} {wall:.3f} {executed} "
                     + "/".join(map(str, n_launch.values()))
                     + f" {same_n} {max(diffs.values()):.1e}")
        assert same_n, (knob, {k: (n_it[k] != ref[2][k]).sum() for k in ks})
        if knob != "CNMF_TPU_STAGED":
            assert max(diffs.values()) == 0.0, (knob, diffs)
        elif max(diffs.values()) > 0:
            differ = diffs
    with env_knobs(unset):
        ref2 = sched_grid(X_host, Xd, jobs, kwargs)
    assert all(np.array_equal(ref2[1][k], ref[1][k]) for k in ks)
    print(f"[sched] CD K={ks[0]}..{ks[-1]} x {n_iter}, factorize_grid (wall "
          "s, restart-sweeps, launches W/H; n_iter equal, max|diff| vs the "
          f"per-K default): per-K {ref[0]:.3f}+{ref2[0]:.3f} {ref[3]}; "
          + "; ".join(parts), flush=True)
    if differ:
        prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
        tpm = torch.as_tensor(np.ascontiguousarray(prep.tpm, np.float32),
                              device=Xd.device)
        worst = max(differ, key=differ.get)
        gaps = []
        for k in sorted({k_cons, worst}):
            res = [stages.consensus_arrays(
                stages.combine_arrays(list(s[k])), k, Xd, tpm, prep.tpm_std,
                prep.hvg_idx, kwargs, density_threshold=0.5)
                for s in (ref[1], runs["CNMF_TPU_STAGED"][1])]
            gap = {key: rel_sse(getattr(res[1], key), getattr(res[0], key))
                   for key in ("spectra", "usages", "spectra_tpm",
                               "spectra_score")}
            gaps.append(f"K={k} " + "/".join(f"{v:.1e}" for v in
                                             gap.values()))
            assert max(gap.values()) < SCHED_SSE, (k, gap)
        print("[sched] staged bits differ at K=" + ",".join(
            f"{k}:{d:.1e}" for k, d in differ.items() if d > 0)
            + "; consensus rel SSE spectra/usages/tpm/score "
            + "; ".join(gaps) + f" (bound {SCHED_SSE:g})", flush=True)

    print("[sched] autowarm (s from its start): build " + warm, flush=True)
    return launches


def phase_profile_refits(counts, hvg, dev, spectra, k, kwargs,
                         density_threshold, label, wrapper, k_stats=True):
    """A MU slice's k-stats (``k_stats``) and consensus at K=k on its merged
    spectra, again under torch.profiler (their MU work is the B=1 refits):
    each stage's wall, device-busy time, idle share, the B=1 launches of the
    kernel ``wrapper`` names and the top device ops."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    Xd, tpm = (torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=dev) for a in (prep.norm, prep.tpm))
    stage_fns = [("consensus", lambda: stages.consensus_arrays(
        spectra, k, Xd, tpm, prep.tpm_std, prep.hvg_idx, kwargs,
        density_threshold=density_threshold))]
    if k_stats:
        stage_fns.insert(0, ("k_stats", lambda: stages.k_stats_arrays(
            {k: spectra}, Xd, kwargs)))
    fn_b1, parts = getattr(mk, wrapper), []
    for stage, fn in stage_fns:
        fn_b1.launches_b1 = 0
        _, wall, busy, top = profiled(fn, n_top=1)
        parts.append(f"{stage} wall {wall:.3f} s, device busy {busy:.3f} s, "
                     f"idle share {1 - busy / wall:.2%}, "
                     f"{fn_b1.launches_b1} B=1 {wrapper} launches; "
                     f"top device op: {top}")
    print(f"[profile] {label} (profiled) " + " | ".join(parts), flush=True)


def phase_small_agreement(dev, nmf_kwargs=None, label="frobenius"):
    """The slice at the verify recipe's size (300×400 counts, K=5,6 × 5
    restarts, 200 HVGs, consensus K=6, the K-selection stats of K=5 and 6),
    f32 on the card and on the CPU, both with the host's inits and kmeans++
    seeding (HOST_DRAWS on the card, the CPU's default): the consensus
    artifacts must agree within the repo's SSE contract. Also prints whether each restart took as
    many sweeps on both, and how far the K-selection stats differ."""
    rng = np.random.RandomState(42)
    W = rng.gamma(0.7, 1.0, size=(300, 6))
    H = rng.gamma(0.5, 1.0, size=(6, 400)) * (rng.rand(6, 400) < 0.3)
    X = rng.poisson(W @ H * 2.0).astype(float)
    X[X.sum(1) == 0, 0] = 1
    # the CPU draws its inits and seeds on the host: so does the card here
    with host_draws():
        _, merged_gpu, gpu, it_gpu, _, ks_gpu = run_stages(
            X, [5, 6], 5, 200, 6, dev, nmf_kwargs=nmf_kwargs, k_stats=(5, 6))
    _, merged_cpu, cpu, it_cpu, _, ks_cpu = run_stages(
        X, [5, 6], 5, 200, 6, "cpu", nmf_kwargs=nmf_kwargs, k_stats=(5, 6))
    merged_diff = max(float(np.abs(merged_gpu[k] - merged_cpu[k]).max()
                            / np.abs(merged_cpu[k]).max()) for k in (5, 6))
    sse = {name: float(((getattr(gpu, name) - getattr(cpu, name)) ** 2).sum()
                       / (getattr(cpu, name) ** 2).sum())
           for name in ("spectra", "usages", "spectra_tpm", "spectra_score")}
    sweeps = {k: (it_gpu[k].tolist(), it_cpu[k].tolist()) for k in it_gpu}
    same = all(a == b for a, b in sweeps.values())
    stats = "; ".join(
        f"K={g[0]} {g[2]:.6g}/{c[2]:.6g} {g[3]:.6g}/{c[3]:.6g}"
        for g, c in zip(ks_gpu, ks_cpu))
    print(f"[small] {label}, card vs CPU at 300x400, K=6: merged max rel "
          f"diff {merged_diff:.3e}; consensus rel SSE spectra/usages/tpm/"
          "score " + "/".join(f"{v:.1e}" for v in sse.values())
          + f" (bound {SMALL_SSE_BOUND:g}); same sweeps: {same}"
          + ("" if same else f" {sweeps}") + "; k-stats sil/err card/CPU "
          f"{stats}", flush=True)
    assert max(sse.values()) < SMALL_SSE_BOUND, sse
    assert [r[0] for r in ks_gpu] == [r[0] for r in ks_cpu] == [5, 6]
    for g, c in zip(ks_gpu, ks_cpu):
        assert abs(g[2] - c[2]) <= K_STATS_SIL_ABS, (label, g, c)
        assert abs(g[3] - c[3]) <= K_STATS_ERR_REL * abs(c[3]), (label, g, c)


HOST_DRAWS = {"CNMF_TPU_DEVICE_INIT": "0", "CNMF_TPU_DEVICE_KMEANSPP": "0"}


@contextlib.contextmanager
def env_knobs(values):
    """The environment's knobs set to ``values`` for the block, restored
    after (None: unset)."""
    saved = {knob: os.environ.get(knob) for knob in values}
    for knob, value in values.items():
        if value is None:
            os.environ.pop(knob, None)
        else:
            os.environ[knob] = value
    try:
        yield
    finally:
        for knob, value in saved.items():
            if value is None:
                os.environ.pop(knob, None)
            else:
                os.environ[knob] = value


def host_draws():
    """HOST_DRAWS set for the block: the host's inits and kmeans++ seeding
    on the card, the knobs restored after."""
    return env_knobs(HOST_DRAWS)


def phase_k_selection(merged, Xd):
    """The K-selection stats of every K of the CD slice's merged spectra, K
    by K; the products kernel's launches over the sweep."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.pipeline import stages

    kwargs = stages.nmf_run_params()
    ck.cd_sweep_from_products.launches = 0
    parts, t_all = [], time.perf_counter()
    for k in sorted(merged):
        t0 = time.perf_counter()
        (row,) = stages.k_stats_arrays({k: merged[k]}, Xd, kwargs)
        torch.cuda.synchronize()
        parts.append(f"{k}: {row[2]:.4f} {row[3]:.6g} "
                     f"{time.perf_counter() - t0:.3f}s")
        assert np.isfinite(row[2:]).all(), row
    launches = ck.cd_sweep_from_products.launches
    print(f"[k-selection] CD slice (K: silhouette, error, wall) "
          + "; ".join(parts) + f"; total {time.perf_counter() - t_all:.3f} s; "
          f"cd_sweep_from_products launches {launches}",
          flush=True)
    assert launches > 0


FUSED_SSE = 1e-4          # one-program against step-by-step consensus


def source_site(module, text):
    """"file:line" of the first line of ``module`` holding ``text``."""
    import inspect

    lines, _ = inspect.getsourcelines(module)
    line = next(i for i, s in enumerate(lines, 1) if text in s)
    return f"{os.path.basename(module.__file__)}:{line}"


def sync_sites(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result,
    {"file:line": count} of the synchronizing calls made while it ran, each
    by the innermost line of the package's code on the stack, or as
    "outside <file:line>" when no package code was on it: a call of the
    harness around fn, not of the path)."""
    import collections
    import traceback
    import warnings

    import torch

    package = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "cnmf_tpu_torch")
    sites = collections.Counter()

    def hook(message, category, filename, lineno, *args, **kwargs):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack
                if os.path.abspath(f.filename).startswith(package)]
        if ours:
            sites[f"{os.path.basename(ours[-1].filename)}:"
                  f"{ours[-1].lineno}"] += 1
            return
        caller = [f for f in stack if "torch" not in f.filename
                  and not f.filename.endswith("warnings.py")][-1]
        sites[f"outside {os.path.basename(filename)}:{lineno} from "
              f"{os.path.basename(caller.filename)}:{caller.lineno}"] += 1

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, dict(sites)


def phase_fused(label, merged, counts, hvg, k, dev, kwargs, wrappers,
                density_threshold=0.5):
    """Consensus at K=k on a slice's merged spectra through the one-program
    path (the CUDA default: ops/consensus_fused.fused_consensus_full) and
    step by step (CNMF_TPU_FUSED_CONSENSUS=0's path), in paired turns: the
    labels must be equal, every artifact within FUSED_SSE, and the one
    program's synchronizing calls (sync_sites) only the Lloyd and refit
    loops' block checks and one drain. Prints the walls, the calls of
    each and the launches of ``wrappers`` in one one-program run."""
    import torch

    from cnmf_tpu_torch.ops import consensus_fused, kmeans, nmf
    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    Xd, tpm = (torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=dev) for a in (prep.norm, prep.tpm))

    def run(fused):
        return stages.consensus_arrays(
            merged, k, Xd, tpm, prep.tpm_std, prep.hvg_idx, kwargs,
            density_threshold=density_threshold, fused=fused)

    res, walls = {}, {True: [], False: []}
    for fused in (True, False, False, True):
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[fused] = run(fused)
        torch.cuda.synchronize()
        walls[fused].append(time.perf_counter() - t0)
        if fused:
            launches = {name: fn.launches for name, fn in wrappers.items()
                        if fn.launches}
    syncs = {fused: sync_sites(lambda: run(fused))[1]
             for fused in (True, False)}
    kinds = {source_site(kmeans, "torch.stack([new_done.all(), emptied])"):
             "lloyd",
             source_site(kmeans, "all_done = bool(new_done.all())"): "lloyd",
             source_site(nmf, "if n and bool(state[-2].all())"): "refits",
             source_site(consensus_fused, "for t in ts]).cpu()"): "drain"}
    by_kind = {}
    for site, n in syncs[True].items():
        kind = "outside" if site.startswith("outside") else kinds.get(site,
                                                                      site)
        by_kind[kind] = by_kind.get(kind, 0) + n
    outside = [site for site in syncs[True] if site.startswith("outside")]
    a, b = res[True], res[False]
    same = bool(np.array_equal(a.labels, b.labels)
                and np.array_equal(a.density_filter, b.density_filter))
    sse = {n: rel_sse(getattr(a, n), getattr(b, n))
           for n in ("spectra", "usages", "spectra_tpm", "spectra_score")}
    print(f"[fused] {label} K={k}: labels equal {same}; rel SSE spectra/"
          "usages/tpm/score " + "/".join(f"{v:.1e}" for v in sse.values())
          + f"; wall s fused {'+'.join(f'{w:.3f}' for w in walls[True])}, "
          f"steps {'+'.join(f'{w:.3f}' for w in walls[False])}; syncs fused "
          f"{sum(syncs[True].values())} {json.dumps(by_kind)}"
          + (f" ({', '.join(outside)})" if outside else "")
          + f" / steps {sum(syncs[False].values())}; launches {launches}",
          flush=True)
    assert same and max(sse.values()) <= FUSED_SSE, (same, sse)
    assert set(by_kind) <= {"lloyd", "refits", "drain", "outside"}, by_kind
    assert by_kind.get("drain") == 1, by_kind
    return launches


DRAIN_SSE = 1e-6          # twin-fed against host-fed consensus, rel SSE


def phase_drain(dev, counts, hvg, ks, n_iter, k_cons, merged, wrappers):
    """``[drain]``: the CD grid again through stages.factorize_grid, as
    cNMF.factorize runs it (every K's true-K spectra packed on the card,
    one device-to-host copy into pinned memory on a side stream, split per
    K), its write callback putting the per-iteration npz files on a pool of
    8 threads; its spectra must be bit-equal to the per-K path's
    (``merged``, stages.factorize_k per K). Prints the copies and bytes of
    each path and the phase split (CNMF_TPU_PHASES' keys). Then the twin
    (the K=10 rows of the packed tensor) feeds consensus and the
    k-selection sweep in place of the host spectra: labels equal, every
    artifact within DRAIN_SSE, the sweep's table against the host-fed one,
    the two sweeps timed in paired turns; and consensus's walls with a
    one-thread writer busy writing the 900 files again and idle, in paired
    turns. Last, the grid once more with the deferred drain of a cNMF (its
    ``_defer_packed``, the default under the CLI on a card): factorize
    returns before the copy has landed, consensus runs from the stack
    memo's twin while the writer waits for the copy and writes the files,
    and after the flush the landed batches are bit-equal to ``merged``.
    Returns the CD kernels' launches over the phase (> 0 each)."""
    from concurrent.futures import ThreadPoolExecutor

    import pandas as pd
    import torch

    from cnmf_tpu_torch import cNMF
    from cnmf_tpu_torch.io.dataframe import load_df_from_npz, save_df_to_npz
    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    tpm = torch.as_tensor(np.ascontiguousarray(prep.tpm, dtype=np.float32),
                          device=dev)
    kwargs = stages.nmf_run_params()
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    jobs = [(k, seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]],
             np.arange(n_iter)) for k in sorted(set(ks))]
    phases = dict.fromkeys(("upload_s", "init_s", "dispatch_s",
                            "solve_wait_s", "result_fetch_s", "write_s"),
                           0.0)
    phases.update(upload_bytes=X_host.nbytes, result_bytes=0)
    copies = []
    base = stages.HostFetch

    class Counted(base):
        def __init__(self, src):
            copies.append(src.numel() * src.element_size())
            super().__init__(src)

    for fn in wrappers.values():
        fn.launches = 0
    got, twins, futs = {}, {}, []
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir, \
            ThreadPoolExecutor(max_workers=8) as pool:
        path = os.path.join(workdir, "spectra.k_%d.iter_%d.df.npz")
        frames = {}

        def write(k, iters, batch, twin):
            got[k], twins[k] = batch, twin
            for i, it in enumerate(iters):
                frames[k, it] = pd.DataFrame(batch[i])
                futs.append(pool.submit(save_df_to_npz, frames[k, it],
                                        path % (k, it)))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Xd = torch.as_tensor(X_host, device=dev)
        stages.stream_barrier(Xd)
        phases["upload_s"] = time.perf_counter() - t0
        stages.HostFetch = Counted
        try:
            stages.factorize_grid(X_host, Xd, jobs, kwargs, write,
                                  phases=phases, twin=True)
        finally:
            stages.HostFetch = base
        t1 = time.perf_counter()
        for f in futs:
            f.result()
        phases["write_s"] += time.perf_counter() - t1
        wall = time.perf_counter() - t0
        same = all(np.array_equal(got[k].reshape(merged[k].shape), merged[k])
                   for k in merged)
        packed, off, rows = twins[k_cons]
        twin = packed[off:off + rows]

        def consensus(spectra):
            out = stages.consensus_arrays(spectra, k_cons, Xd, tpm,
                                          prep.tpm_std, prep.hvg_idx, kwargs)
            torch.cuda.synchronize()
            return out

        def agree(fed):
            return (bool(np.array_equal(host.labels, fed.labels)),
                    max(rel_sse(getattr(fed, n), getattr(host, n))
                        for n in ("spectra", "usages", "spectra_tpm",
                                  "spectra_score")))

        host = consensus(merged[k_cons])
        labels, sse = agree(consensus(twin))
        walls, busy_through = {"idle": [], "busy": []}, True
        with ThreadPoolExecutor(max_workers=1) as writer:
            for turn in ("idle", "busy", "busy", "idle"):
                queued = ([writer.submit(save_df_to_npz, frame, path % key)
                           for key, frame in frames.items()]
                          if turn == "busy" else [])
                t2 = time.perf_counter()
                consensus(twin)
                walls[turn].append(time.perf_counter() - t2)
                busy_through &= not any(f.done() for f in queued[-1:])
                for f in queued:
                    f.result()
        fed_twins = {k: t[0][t[1]:t[1] + t[2]] for k, t in twins.items()}
        sweeps = {"twins": [], "host": []}
        for turn in ("twins", "host", "host", "twins"):
            t3 = time.perf_counter()
            rows_k = stages.k_stats_arrays(
                fed_twins if turn == "twins" else merged, Xd, kwargs)
            sweeps[turn].append(time.perf_counter() - t3)
            if turn == "twins":
                dev_rows = rows_k
            else:
                host_rows = rows_k

        # the deferred drain of a cNMF, as its factorize runs it under
        # CNMF_TPU_ASYNC_WRITES=1 on the card
        obj = cNMF(output_dir=workdir, name="deferred", device=dev)
        genes = pd.Index(["g%d" % j for j in range(X_host.shape[1])])
        t4 = time.perf_counter()
        stages.factorize_grid(
            X_host, Xd, jobs, kwargs, write=None, twin=True,
            defer=lambda entries, pk, fetch: obj._defer_packed(
                entries, pk, fetch, genes, lambda key, value: None))
        returned = time.perf_counter() - t4
        files = [(int(it), obj.paths["iter_spectra"] % (k_cons, int(it)))
                 for it in range(n_iter)]
        _, _, (pk, off, rows) = obj._recall_spectra_stack(
            k_cons, files, join=False)
        d_labels, d_sse = agree(consensus(pk[off:off + rows]))
        writing = obj._write_pending(
            obj.paths["iter_spectra"] % (ks[-1], n_iter - 1))
        obj.flush_writes()
        flushed = time.perf_counter() - t4
        landed = {k: obj._recall_spectra_stack(
            k, [(it, obj.paths["iter_spectra"] % (k, it))
                for it in range(n_iter)])[0] for k in merged}
        d_same = all(np.array_equal(landed[k], merged[k]) for k in merged)
        d_file = all(np.array_equal(load_df_from_npz(
            obj.paths["iter_spectra"] % (k, n_iter - 1)).values,
            merged[k][-k:]) for k in merged)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    sil = max(abs(a[2] - b[2]) for a, b in zip(dev_rows, host_rows))
    err = max(abs(a[3] - b[3]) / abs(b[3]) for a, b in zip(dev_rows,
                                                           host_rows))
    best = (max(dev_rows, key=lambda r: r[2])[0],
            max(host_rows, key=lambda r: r[2])[0])
    n_files = sum(len(j[2]) for j in jobs)
    print(f"[drain] CD K={ks[0]}..{ks[-1]} x {n_iter} via factorize_grid "
          f"{wall:.3f} s ({n_files} npz, 8 threads): bit-equal to per-K "
          f"{same}; {len(copies)} copy {sum(copies) / 1e6:.1f} MB (per-K "
          f"{len(merged)}); phases " + json.dumps(
              {k: round(v, 4) if isinstance(v, float) else v
               for k, v in phases.items()}, separators=(",", ":"))
          + "; launches W/H/products " + "/".join(map(str, launches.values())),
          flush=True)
    print(f"[drain] twin-fed consensus K={k_cons} vs host: labels equal "
          f"{labels}, rel SSE {sse:.1e}; k-selection s twins/host/host/twins "
          f"{sweeps['twins'][0]:.3f}/{sweeps['host'][0]:.3f}/"
          f"{sweeps['host'][1]:.3f}/{sweeps['twins'][1]:.3f}, |d sil| "
          f"{sil:.1e}, rel d err {err:.1e}, best K {best[0]}/{best[1]}; "
          "consensus s writer idle/busy/busy/idle "
          f"{walls['idle'][0]:.3f}/{walls['busy'][0]:.3f}/"
          f"{walls['busy'][1]:.3f}/{walls['idle'][1]:.3f} (busy throughout "
          f"{busy_through}); deferred drain: grid returned {returned:.3f} s, "
          f"flushed {flushed:.3f} s, memo-twin consensus labels "
          f"equal {d_labels} rel SSE {d_sse:.1e} (writer busy after "
          f"{writing}), landed bit-equal {d_same}, files {d_file}",
          flush=True)
    assert same and len(copies) == 1, (same, copies)
    assert labels and sse <= DRAIN_SSE, (labels, sse)
    assert d_labels and d_sse <= DRAIN_SSE, (d_labels, d_sse)
    assert d_same and d_file, (d_same, d_file)
    assert all(np.isfinite(r[2:]).all() for r in dev_rows), dev_rows
    assert all(n > 0 for n in launches.values()), launches
    return launches


def phase_device_tpm(dev, counts, hvg, ks, n_iter):
    """The compact integer TPM (ops/device_tpm.py) on the slice's counts:
    the bytes each upload moves (the integer image dense and as CSR, the
    float TPM), the device TPM against the host's (largest relative
    error), the CSR image bit-equal to the dense, the one-pass derive of the
    factorize input and the TPM (seconds; its TPM bit-equal to the
    expansion alone), the prefetch alone, and the CD factorize of every K
    with and without the prefetch running beside it, in paired turns."""
    import torch

    from cnmf_tpu_torch.ops import device_tpm
    from cnmf_tpu_torch.pipeline import stages

    def sync_wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    ints = device_tpm.compact_integer_counts(counts)
    assert ints is not None, "the slice's counts have no compact image"
    scale = device_tpm.tpm_row_scale(counts).astype(np.float32)
    csr = device_tpm.int_image_csr(ints)
    # the CSR route on the card, taken here whatever its byte gate says
    components = csr or device_tpm.csr_components(ints)
    secs, nbytes = {}, {}
    t0 = time.perf_counter()
    image, nbytes["int"] = device_tpm.upload_int_image(ints, None, dev)
    secs["int"] = sync_wall(t0)
    t0 = time.perf_counter()
    from_csr, nbytes["csr"] = device_tpm.upload_int_image(ints, components,
                                                          dev)
    secs["csr"] = sync_wall(t0)
    same_csr = bool(torch.equal(from_csr, image))
    del from_csr
    t0 = time.perf_counter()
    tpm_float = torch.as_tensor(np.ascontiguousarray(prep.tpm,
                                                     dtype=np.float32),
                                device=dev)
    secs["float"] = sync_wall(t0)
    nbytes["float"] = tpm_float.numel() * 4
    scale_d = torch.as_tensor(scale, device=dev)
    tpm_dev = device_tpm.tpm_from_counts(image, scale_d)
    nz = tpm_float != 0
    rel = float(((tpm_dev - tpm_float).abs() / tpm_float.abs().clamp(
        min=1e-30))[nz].max())
    assert bool((tpm_dev[~nz] == 0).all())
    cols = np.asarray(prep.hvg_idx, dtype=np.int64)
    std = np.asarray(counts)[:, cols].astype(np.float64).std(axis=0, ddof=1)
    cols_d = torch.as_tensor(cols, device=dev)
    std_d = torch.as_tensor(std.astype(np.float32), device=dev)
    t0 = time.perf_counter()
    norm_d, tpm_d = device_tpm.derive_norm_and_tpm(image, cols_d, std_d,
                                                   scale_d)
    derive_s = sync_wall(t0)
    same_derive = bool(torch.equal(tpm_d, tpm_dev))
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    norm_rel = float((norm_d.cpu() - torch.from_numpy(X_host)).abs().max()
                     / np.abs(X_host).max())
    del image, tpm_float, tpm_dev, norm_d, tpm_d
    t0 = time.perf_counter()
    task = device_tpm.prefetch(ints, scale, dev, csr=csr)
    tpm_p, prefetch_bytes = task.join()
    prefetch_s = sync_wall(t0)
    del tpm_p

    Xd = torch.as_tensor(X_host, device=dev)
    kwargs = stages.nmf_run_params()
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    walls, ahead = {True: [], False: []}, []
    for prefetch in (True, False, False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task = (device_tpm.prefetch(ints, scale, dev, csr=csr) if prefetch
                else None)
        for k in ks:
            rows = [i for i, (kk, _) in enumerate(grid) if kk == k]
            stages.factorize_k(X_host, Xd, k, seeds[rows], kwargs)
        walls[prefetch].append(sync_wall(t0))
        if task is not None:
            ahead.append(task.done())
            task.join()
    moved = ", ".join(f"{key} {nbytes[key] / 1e6:.1f} MB {secs[key]:.4f} s"
                      for key in ("int", "csr", "float"))
    print(f"[device-tpm] {counts.shape[0]}x{counts.shape[1]} counts as "
          f"{ints.dtype}: {moved} (CSR gate: {csr is not None}), CSR "
          f"bit-equal {same_csr}; TPM vs host max rel {rel:.2e}; derive "
          f"{derive_s:.4f} s (TPM bit-equal {same_derive}, norm max rel "
          f"{norm_rel:.1e}); prefetch {prefetch_s:.3f} s, "
          f"{prefetch_bytes / 1e6:.1f} MB; CD K={ks[0]}..{ks[-1]} with / "
          f"without it {'+'.join(f'{w:.3f}' for w in walls[True])} / "
          f"{'+'.join(f'{w:.3f}' for w in walls[False])} s (done before: "
          f"{ahead})", flush=True)
    assert rel <= 3e-7 and same_derive and same_csr, (rel, same_derive,
                                                      same_csr)
    assert norm_rel <= 1e-6, norm_rel


def check_result(result, k, hvg):
    """Finite consensus arrays of the expected shapes at the 2700x10000
    size; returns the usages normalized to rows summing to 1."""
    for name in ("spectra", "usages", "spectra_tpm", "spectra_score"):
        assert np.isfinite(getattr(result, name)).all(), name
    assert result.spectra.shape == (k, hvg)
    assert result.usages.shape == (2700, k)
    assert result.spectra_tpm.shape == (k, 10000)
    return result.usages / result.usages.sum(axis=1, keepdims=True)


def mu_slice(label, counts, k_cons, n_iter, hvg, dev, kwargs, names,
             k_stats=(), density_threshold=0.5):
    """One MU path at bench.py's KL configuration through pipeline/stages.py;
    returns the launches of ``names``' wrappers, each of which must be > 0,
    of those the launches with one restart (the refits), and the merged
    spectra of K=k_cons."""
    from cnmf_tpu_torch.ops import mu_kernels as mk

    wrappers = {name: getattr(mk, name) for name in names}
    for fn in wrappers.values():
        fn.launches = fn.launches_b1 = 0
    walls, merged, result, n_iters, _, k_rows = run_stages(
        counts, [k_cons], n_iter, hvg, k_cons, dev,
        nmf_kwargs=kwargs, k_stats=k_stats,
        density_threshold=density_threshold)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches_b1 = {name: fn.launches_b1 for name, fn in wrappers.items()}
    usage = check_result(result, k_cons, hvg)
    assert np.allclose(usage.sum(axis=1), 1.0), "usage rows must sum to 1"
    its = n_iters[k_cons]
    stats = "".join(f"; k-stats K={r[0]}: silhouette {r[2]:.6g}, prediction "
                    f"error {r[3]:.6g}" for r in k_rows)
    density = np.percentile(result.local_density, [0, 50, 100])
    print(f"[{label}-slice] 2700x10000 counts, {hvg} HVGs, K={k_cons} x "
          f"{n_iter} restarts, beta_loss={kwargs['beta_loss']}, max_iter "
          f"{kwargs['max_iter']}, consensus K={k_cons} dt {density_threshold:g} "
          f"(density min/median/max {density[0]:.4f}/{density[1]:.4f}/"
          f"{density[2]:.4f}, {int(result.density_filter.sum())} of "
          f"{len(result.density_filter)} kept): walls_s "
          + json.dumps({k: round(v, 3) for k, v in walls.items()})
          + f"; iterations max {its.max()} mean {its.mean():.1f}{stats}; "
          f"launches {launches}, of which B=1 {launches_b1}",
          flush=True)
    assert all(n > 0 for n in launches.values()), launches
    return launches, launches_b1, merged[k_cons]


# the [preprocess] phase: a 4-sample study for cNMF with Harmony —
# tests/test_preprocess.py:make_batched_adata's recipe at 4 batches of 5,000
# cells × 10,000 genes, Preprocess at its published defaults (2,000 seurat_v3
# HVGs, PCA 50, Harmony theta 1, 20 iterations of at most 20 rounds, K =
# min(N/30, 100) = 100 clusters), then cNMF on the corrected HVGs at K=10 ×
# 20 restarts from nndsvd inits (each a host randomized SVD of the 20,000 ×
# 2,000 matrix, so 20 and not 100)
PP_BATCHES, PP_CELLS, PP_GENES, PP_SHIFT = 4, 5000, 10000, 300
PP_HVG, PP_K, PP_RESTARTS = 2000, 10, 20
PP_SEPARATION = 0.7      # corrected / uncorrected batch separation, at most
PP_REFIT_REL = 1e-6      # cNMF's refits against the solver calls, f32
# Harmony on one embedding, CPU against the card: rounds apart, Z_corr's
# max diff / max, the share of cells whose matched top cluster agrees
PP_ONE_ROUNDS, PP_ONE_Z_REL, PP_ONE_MATCHED = 2, 1e-3, 0.9


def batched_counts(n_batches, per_batch, n_genes, shift_genes, programs=8,
                   seed=0):
    """Poisson counts of ``programs`` gamma programs over a sparse gamma H,
    lam = W·H + 0.5, with a block of ``shift_genes`` genes, its own for each
    batch b >= 1, multiplied by 2.5 there; built batch by batch as CSR on the
    host. Returns the port's AnnData with obs["batch"]."""
    import pandas as pd
    import scipy.sparse as sp

    from cnmf_tpu_torch.io.anndata_lite import AnnData

    rng = np.random.RandomState(seed)
    H = (rng.gamma(1.0, 1.0, size=(programs, n_genes))
         * (rng.rand(programs, n_genes) < 0.4))
    blocks = []
    for b in range(n_batches):
        lam = rng.gamma(1.0, 1.0, size=(per_batch, programs)) @ H + 0.5
        if b:
            lam[:, b * shift_genes:(b + 1) * shift_genes] *= 2.5
        X = rng.poisson(lam).astype(np.float32)
        X[X.sum(axis=1) == 0, 0] = 1
        blocks.append(sp.csr_matrix(X))
    n = n_batches * per_batch
    obs = pd.DataFrame({"batch": np.repeat([f"s{b}" for b in range(n_batches)],
                                           per_batch)},
                       index=[f"c{i}" for i in range(n)])
    var = pd.DataFrame(index=[f"g{j}" for j in range(n_genes)])
    return AnnData(sp.vstack(blocks).tocsr(), obs=obs, var=var)


def batch_separation(M, batch):
    """tests/test_preprocess.py's batch-centroid separation over every batch:
    the root sum of squares of each batch's centroid distance from the other
    cells', in units of each gene's std."""
    s = M.std(axis=0) + 1e-9
    return float(np.sqrt(sum(
        np.sum(((M[batch == b].mean(0) - M[batch != b].mean(0)) / s) ** 2)
        for b in np.unique(batch))))


def label_agreement(la, lb, K):
    """(cells with the same label, cells left in agreement once each label
    of ``la`` is matched to the label of ``lb`` that shares most of its
    cells), of two labelings of the same cells into K clusters."""
    overlap = np.zeros((K, K), dtype=np.int64)
    np.add.at(overlap, (la, lb), 1)
    return int((la == lb).sum()), int(overlap.max(axis=1).sum())


def phase_harmony_one_embedding(pp, cpu_pp, obs, dev):
    """What parts the card's and the CPU's Preprocess runs. (1) Harmony's
    starting clusters (kmeans++ on the host, Lloyd on the card) from each
    device's PCs: printed. (2) Harmony on one input, the card's PCs, on the
    CPU as ``Preprocess.harmony_correct_X`` runs it and again on the card:
    the same iterations, rounds within PP_ONE_ROUNDS, Z_corr within
    PP_ONE_Z_REL of max, the top cluster the same for PP_ONE_MATCHED of the
    cells once clusters are matched, and the card repeating its R."""
    import torch

    from cnmf_tpu_torch.harmony import _cells, _init_centroids, run_harmony

    hr = pp.harmony_result
    pcs = pp.pca_embedding
    pc_diff = float(np.abs(pcs - cpu_pp.pca_embedding).max()
                    / np.abs(cpu_pp.pca_embedding).max())
    seeds = [_init_centroids(torch.as_tensor(_cells(p.pca_embedding)[1],
                                             device=dev), hr.K, 0)
             for p in (pp, cpu_pp)]
    seed_same, seed_matched = label_agreement(seeds[0][0], seeds[1][0], hr.K)
    y_diff = float(np.abs(seeds[0][1] - seeds[1][1]).max())
    runs, walls = {}, {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        runs[where] = run_harmony(pcs, obs, "batch", theta=1,
                                  max_iter_harmony=20, random_state=0,
                                  device=d)
        if where == "card":
            torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
    a, b = runs["cpu"], hr
    same, matched = label_agreement(a.R.argmax(0), b.R.argmax(0), hr.K)
    z_diff = float(np.abs(a.Z_corr - b.Z_corr).max() / np.abs(a.Z_corr).max())
    repeats = np.array_equal(runs["card"].R, hr.R)
    n = hr.R.shape[1]
    print(f"[preprocess-harmony] the CPU's PCs {pc_diff:.3e} of max from the "
          f"card's; starting clusters from each: labels the same for "
          f"{seed_same} of {n} cells ({seed_matched} matched), centroids "
          f"max diff {y_diff:.3e}. Harmony on the card's PCs, CPU / card "
          f"again: {walls['cpu']:.3f} / {walls['card']:.3f} s, iterations "
          f"{a.iterations} / {b.iterations}, rounds {a.rounds} / {b.rounds}; "
          f"R max diff {float(np.abs(a.R - b.R).max()):.3e}, Z_corr "
          f"{z_diff:.3e} of max (bound {PP_ONE_Z_REL:g}); top cluster the "
          f"same for {same} cells, {matched} matched (bound "
          f"{PP_ONE_MATCHED:g} of {n}); the card repeats its R: {repeats}",
          flush=True)
    assert a.iterations == b.iterations, (a.iterations, b.iterations)
    assert abs(a.rounds - b.rounds) <= PP_ONE_ROUNDS, (a.rounds, b.rounds)
    assert z_diff <= PP_ONE_Z_REL, z_diff
    assert matched >= PP_ONE_MATCHED * n, matched
    assert repeats


def phase_preprocess(dev):
    """Preprocess with Harmony on the card (and again on the CPU, to print
    how far the two differ), then cNMF on the corrected HVGs from nndsvd
    inits, consensus, and cNMF.refit_usage / refit_spectra against the
    solver calls they wrap."""
    import pandas as pd
    import scipy.sparse as sp
    import torch

    from cnmf_tpu_torch import Preprocess, cNMF
    from cnmf_tpu_torch.io.anndata_lite import AnnData
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.pipeline import solvers, stages

    t0 = time.perf_counter()
    adata = batched_counts(PP_BATCHES, PP_CELLS, PP_GENES, PP_SHIFT)
    sim_s = time.perf_counter() - t0
    runs = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        pp = Preprocess(random_seed=14, device=device)
        t0 = time.perf_counter()
        out = pp.preprocess_for_cnmf(
            AnnData(adata.X, obs=adata.obs.copy(), var=adata.var.copy()),
            harmony_vars="batch", n_top_rna_genes=PP_HVG)
        runs[where] = (*out, pp, time.perf_counter() - t0)
    corrected, tp10k, hvgs, pp, wall = runs["card"]
    Xc = np.asarray(corrected.X)
    n = PP_BATCHES * PP_CELLS
    assert Xc.shape == (n, PP_HVG) and len(hvgs) == PP_HVG, Xc.shape
    assert np.isfinite(Xc).all() and (Xc >= 0).all()
    batch = adata.obs["batch"].values
    raw = adata.X[:, adata.var.index.get_indexer(hvgs)].toarray()
    raw = raw / raw.std(axis=0, ddof=1)
    sep = batch_separation(Xc, batch), batch_separation(raw, batch)
    cpu_x, cpu_pp = np.asarray(runs["cpu"][0].X), runs["cpu"][3]
    x_diff = float(np.abs(Xc - cpu_x).max() / np.abs(cpu_x).max())
    r_diff = float(np.abs(pp.harmony_result.R - cpu_pp.harmony_result.R).max()
                   / np.abs(cpu_pp.harmony_result.R).max())
    hr, hc = pp.harmony_result, cpu_pp.harmony_result
    same, matched = label_agreement(hr.R.argmax(0), hc.R.argmax(0), hr.K)
    print(f"[preprocess] {PP_BATCHES}x{PP_CELLS} cells x {PP_GENES} genes "
          f"({adata.X.nnz} nonzeros, simulated in {sim_s:.1f} s), "
          f"{PP_HVG} HVGs, Harmony K={hr.K}: walls_s "
          + json.dumps({k: round(v, 3) for k, v in pp.timings.items()})
          + f" total {wall:.3f} (CPU {runs['cpu'][4]:.3f}: "
          + json.dumps({k: round(v, 3) for k, v in cpu_pp.timings.items()})
          + f"); Harmony {hr.iterations} iterations, {hr.rounds} rounds "
          f"(CPU {hc.iterations}, {hc.rounds}); batch separation "
          f"{sep[0]:.4f} of {sep[1]:.4f} uncorrected "
          f"(ratio {sep[0] / sep[1]:.4f}, bound {PP_SEPARATION}); card vs "
          f"CPU max diff / max: corrected X {x_diff:.3e}, R {r_diff:.3e} "
          f"(top cluster the same for {same} cells, {matched} matched)",
          flush=True)
    assert sep[0] < PP_SEPARATION * sep[1], sep
    phase_harmony_one_embedding(pp, cpu_pp, adata.obs, dev)

    # cNMF on the corrected matrix, as the reference's batch-correction
    # tutorial feeds it: corrected HVGs as counts, TP10K as the TPM
    genes = corrected.var.index
    prep = stages.prepare_arrays(
        Xc, tpm=tp10k.X, tpm_cols=genes.get_indexer(tp10k.var.index),
        hvg_idx=np.arange(len(hvgs)))
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    Xd = torch.as_tensor(X_host, device=dev)
    kwargs = stages.nmf_run_params(init="nndsvd")
    _, seeds = stages.replicate_seeds([PP_K], PP_RESTARTS, 14)
    wrappers = {name: getattr(ck, name) for name in
                ("cd_w_half_sweep", "cd_h_half_sweep",
                 "cd_sweep_from_products")}
    for fn in wrappers.values():
        fn.launches = 0
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spectra, n_iter, executed = stages.factorize_k(X_host, Xd, PP_K, seeds,
                                                   kwargs, timings=timings)
    torch.cuda.synchronize()
    fact_s = time.perf_counter() - t0
    fact_launches = {k: fn.launches for k, fn in wrappers.items()}
    tpm_hvg_idx = tp10k.var.index.get_indexer(hvgs)
    tpm = torch.as_tensor(tp10k.X.toarray().astype(np.float32, copy=False),
                          device=dev)
    t0 = time.perf_counter()
    result = stages.consensus_arrays(
        stages.combine_arrays(list(spectra)), PP_K, Xd, tpm, prep.tpm_std,
        tpm_hvg_idx, kwargs, density_threshold=0.5, zero_safe=True)
    torch.cuda.synchronize()
    cons_s = time.perf_counter() - t0
    for name in ("spectra", "usages", "spectra_tpm", "spectra_score"):
        assert np.isfinite(getattr(result, name)).all(), name
    assert result.spectra.shape == (PP_K, PP_HVG)
    assert result.usages.shape == (n, PP_K)

    # cNMF.refit_usage / refit_spectra on the card against the solver calls
    for fn in wrappers.values():
        fn.launches = 0
    tpm_hvg = tp10k.X[:, tpm_hvg_idx].toarray()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
        obj = cNMF(output_dir=workdir, name="pp", device=dev)
        obj.save_nmf_iter_params(*obj.get_nmf_iter_params(
            ks=[PP_K], n_iter=PP_RESTARTS, random_state_seed=14,
            beta_loss="frobenius", init="nndsvd"))
        gep = np.arange(1, PP_K + 1)
        t0 = time.perf_counter()
        usage = obj.refit_usage(
            pd.DataFrame(X_host, index=corrected.obs.index, columns=hvgs),
            pd.DataFrame(result.spectra, index=gep, columns=hvgs))
        spectra_rf = obj.refit_spectra(
            pd.DataFrame(tpm_hvg, index=corrected.obs.index, columns=hvgs),
            usage)
        refit_s = time.perf_counter() - t0
        run_kwargs = obj._load_run_params()
    refit_launches = wrappers["cd_sweep_from_products"].launches
    want_u = solvers.refit_usages(Xd, result.spectra, run_kwargs)
    want_s = solvers.refit_spectra_transposed(
        torch.as_tensor(np.ascontiguousarray(tpm_hvg, dtype=np.float32),
                        device=dev), usage.values, run_kwargs).T
    assert list(usage.columns) == list(gep) and list(spectra_rf.columns) == hvgs
    u_diff = float(np.abs(usage.values - want_u).max() / np.abs(want_u).max())
    s_diff = float(np.abs(spectra_rf.values - want_s).max()
                   / np.abs(want_s).max())
    print(f"[preprocess-cnmf] corrected HVGs, K={PP_K} x {PP_RESTARTS} "
          f"restarts init=nndsvd: host inits {timings['init']:.3f} s "
          f"({timings['init'] / PP_RESTARTS:.3f} s a restart), factorize "
          f"{fact_s:.3f} s of which solve {fact_s - timings['init']:.3f} s, "
          f"sweeps max {n_iter.max()} mean {n_iter.mean():.1f}, executed "
          f"restart-sweeps {executed}, launches {fact_launches}; consensus "
          f"dt 0.5 {cons_s:.3f} s ({int(result.density_filter.sum())} of "
          f"{len(result.density_filter)} kept); cNMF.refit_usage + "
          f"refit_spectra {refit_s:.3f} s, {refit_launches} "
          f"cd_sweep_from_products launches, against the solver calls max "
          f"diff / max {u_diff:.3e} / {s_diff:.3e} (bound {PP_REFIT_REL:g})",
          flush=True)
    assert u_diff <= PP_REFIT_REL and s_diff <= PP_REFIT_REL, (u_diff, s_diff)
    assert fact_launches["cd_w_half_sweep"] > 0, fact_launches
    assert fact_launches["cd_h_half_sweep"] > 0, fact_launches
    assert refit_launches > 0


# the [atlas] phase: extras/atlas_validate.synthesize's recipe at its
# defaults — 100,000 cells × 20,000 genes, 12 planted gamma programs over a
# sparse gamma H (8 % of entries), a gamma base rate, Poisson counts (about
# 12 % fill) — drawn on the card in blocks of cells from a seeded generator;
# then 2,000 HVGs, K=12 × 30 restarts and consensus at K=12, density
# threshold 0.5, with the TPM on the card and forced over the device limit
ATLAS_CELLS, ATLAS_GENES, ATLAS_K_TRUE, ATLAS_H_DENSITY = 100_000, 20_000, 12, 0.08
ATLAS_HVG, ATLAS_K, ATLAS_RESTARTS, ATLAS_BLOCK = 2000, 12, 30, 2000
ATLAS_FORCED_SSE = 1e-6   # forced against resident, relative SSE, f32


def atlas_counts(dev, seed=11):
    """The recipe's counts as a float32 CSR matrix on the host, drawn on the
    card block by block (W and H gamma, H's mask, the base rate, Poisson)
    with one seeded torch.Generator; a cell without counts gets one count of
    gene 0, as the recipe does."""
    import scipy.sparse as sp
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def gamma(shape, size):
        return torch._standard_gamma(torch.full(size, shape, device=dev),
                                     generator=g)

    W = gamma(0.5, (ATLAS_CELLS, ATLAS_K_TRUE))
    H = gamma(0.45, (ATLAS_K_TRUE, ATLAS_GENES)) * (
        torch.rand(ATLAS_K_TRUE, ATLAS_GENES, device=dev, generator=g)
        < ATLAS_H_DENSITY)
    base = gamma(0.3, (ATLAS_GENES,)) * 0.02
    data, indices, indptr = [], [], [np.zeros(1, np.int64)]
    for start in range(0, ATLAS_CELLS, ATLAS_BLOCK):
        counts = torch.poisson(W[start:start + ATLAS_BLOCK] @ H + base,
                               generator=g)
        counts[counts.sum(dim=1) == 0, 0] = 1.0
        rows, cols = counts.nonzero(as_tuple=True)   # row-major order
        data.append(counts[rows, cols].cpu().numpy())
        indices.append(cols.to(torch.int32).cpu().numpy())
        per_row = torch.bincount(rows, minlength=counts.shape[0])
        indptr.append(torch.cumsum(per_row, 0).cpu().numpy() + indptr[-1][-1])
    return sp.csr_matrix((np.concatenate(data), np.concatenate(indices),
                          np.concatenate(indptr)),
                         shape=(ATLAS_CELLS, ATLAS_GENES))


def rel_sse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).sum() / (b ** 2).sum())


def phase_atlas_products_kernel(dev, shapes):
    """The products-given sweep against its plain version at the atlas
    refits' shapes (B=1, K=12 padded to 16 with 4 zero columns): max
    relative difference, ms per wrapper call, the kernel alone and the
    plain version, and the bound. Returns {M: values}."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops.kernel_lib import kernel_function, raise_on

    rng = np.random.RandomState(1)
    out = {}
    for M in shapes:
        K, pad, B = 16, 16 - ATLAS_K, 1
        avg = np.sqrt(1.0 / ATLAS_K)
        F = (avg * np.abs(rng.randn(B, M, K))).astype(np.float32)
        Hfix = (avg * np.abs(rng.randn(B, 2000, K))).astype(np.float32)
        F[:, :, -pad:] = 0.0
        Hfix[:, :, -pad:] = 0.0
        F, Hfix = (torch.as_tensor(a, device=dev) for a in (F, Hfix))
        gram = ck._gram(Hfix)
        P = torch.as_tensor(rng.gamma(1.0, 1.0, (B, M, K)).astype(np.float32),
                            device=dev) * gram.diagonal(dim1=1, dim2=2)[:, None]
        kernel, plain = ck.cd_sweep_from_products, ck.cd_sweep_from_products_plain
        res = kernel(F, gram, P)
        check_pad(res, pad)
        abs_err, rel_err = compare(res, plain(F, gram, P))
        assert rel_err <= KERNEL_REL_BOUND, ("atlas products", M, rel_err)
        ms = timed_ms(lambda: kernel(F, gram, P))
        plain_ms = timed_ms(lambda: plain(F, gram, P))
        res, part = torch.empty_like(F), torch.empty((M, B), device=dev)
        launch = kernel_function("cd_half_sweep_products", ck._PRODUCTS_ARGS)
        ptrs = (P.data_ptr(), M, F.data_ptr(), gram.data_ptr(), 0.0, B, K,
                res.data_ptr(), part.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        alone_ms = device_ms(lambda: raise_on("products", launch(*ptrs)))
        bound_ms, by = bound(2 * M * K * K * B, 4 * (3 * B * M * K + B * K * K))
        out[M] = dict(rel=rel_err, abs=abs_err, ms=ms, alone_ms=alone_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms, by=by)
    return out


def phase_atlas_fused_kernels(Xd, restarts, pad):
    """The fused half-sweeps against their plain versions at the atlas
    factorize's shape: the path's normalized counts Xd (100,000 x 2,000),
    ``restarts`` (the ladder's first rung) and K=16 with ``pad`` zero
    columns, factors at sklearn's random-init scale. Returns {name: values}
    (relative and absolute error, ms of the wrapper and of plain, bound)."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck

    N, G = Xd.shape
    B, K = restarts, 16
    g = torch.Generator(device=Xd.device).manual_seed(5)
    avg = float(torch.sqrt(Xd.mean() / (K - pad)))
    W, Ht = (avg * torch.randn(B, M, K, device=Xd.device, generator=g).abs()
             for M in (N, G))
    W[:, :, K - pad:] = 0.0
    Ht[:, :, K - pad:] = 0.0
    out = {}
    for name in ("cd_w_half_sweep", "cd_h_half_sweep"):
        kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
        res = kernel(Xd, W, Ht)
        check_pad(res, pad)
        abs_err, rel_err = compare(res, plain(Xd, W, Ht))
        assert rel_err <= KERNEL_REL_BOUND, ("atlas", name, rel_err)
        bound_ms, by = bound(*kernel_work(name, Xd, B, N, G, K))
        out[name] = dict(rel=rel_err, abs=abs_err,
                         ms=timed_ms(lambda: kernel(Xd, W, Ht)),
                         plain_ms=timed_ms(lambda: plain(Xd, W, Ht)),
                         bound_ms=bound_ms, by=by)
    return out


def phase_atlas_stop_rule(X_host, Xd, seeds, kwargs, path_n_iter):
    """The path's first two restarts solved again on the card from the
    path's inits without the ladder: by the kernels, and by their plain
    versions in float32 and in float64. Returns {route: sweeps of each
    restart}, the path's first."""
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import nmf
    from cnmf_tpu_torch.pipeline import stages
    from cnmf_tpu_torch.pipeline.solvers import device_init_enabled

    # the path's own inits: drawn on the card by default
    W0, Ht0 = stages.restart_factors(
        X_host, Xd, ATLAS_K, seeds[:2], "random", 16, {"init": 0.0},
        device_init_enabled(Xd.device),
        stages.x_mean_for_init(X_host, np.float32))
    solve = dict(tol=float(kwargs["tol"]), max_iter=int(kwargs["max_iter"]))
    sweeps = {"path": [int(n) for n in path_n_iter[:2]]}
    sweeps["kernels"] = nmf.nmf_coordinate_descent(Xd, W0, Ht0, **solve)[2]
    kernels = nmf.cd_w_half_sweep, nmf.cd_h_half_sweep
    nmf.cd_w_half_sweep = ck.cd_w_half_sweep_plain
    nmf.cd_h_half_sweep = ck.cd_h_half_sweep_plain
    try:
        sweeps["plain_f32"] = nmf.nmf_coordinate_descent(Xd, W0, Ht0,
                                                         **solve)[2]
        sweeps["plain_f64"] = nmf.nmf_coordinate_descent(
            Xd.double(), W0.double(), Ht0.double(), **solve)[2]
    finally:
        nmf.cd_w_half_sweep, nmf.cd_h_half_sweep = kernels
    return {k: [int(n) for n in v] for k, v in sweeps.items()}


def phase_mesh_atlas(dev, merged, Xd, prep, kwargs, forced, forced_s,
                     forced_launches):
    """(d) of the [mesh] phase: the forced (over-limit) atlas consensus
    again, on the same data, with its products-given solves row-sharded
    over MESH_SHARDS shards of the card (solvers.shard_products_rows, the
    local devices set to the card MESH_SHARDS times): within MESH_ATLAS_SSE
    of the unsharded forced run. The products kernel's launches are counted
    over this run alone: the row-sharded solves launch once a shard, so
    there must be more than the unsharded run's ``forced_launches``."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.parallel import mesh as pm
    from cnmf_tpu_torch.pipeline import stages

    local = pm.local_devices
    pm.local_devices = lambda: [torch.device(dev)] * MESH_SHARDS
    launches0 = ck.cd_sweep_from_products.launches
    try:
        t0 = time.perf_counter()
        sharded = stages.consensus_arrays(
            merged, ATLAS_K, Xd, prep.tpm, prep.tpm_std, prep.hvg_idx, kwargs,
            density_threshold=0.5, zero_safe=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pm.local_devices = local
    launches = ck.cd_sweep_from_products.launches - launches0
    sse = {name: rel_sse(getattr(sharded, name), getattr(forced, name))
           for name in ("spectra_tpm", "spectra_score", "usages")}
    print(f"[mesh] (d) atlas forced consensus, products rows over "
          f"{MESH_SHARDS} shards: {wall:.3f} s (unsharded {forced_s:.3f}), "
          "rel SSE " + json.dumps({k: float(f"{v:.1e}") for k, v in sse.items()})
          + f" (bound {MESH_ATLAS_SSE:g}), products launches {launches} "
          f"(unsharded {forced_launches})", flush=True)
    assert max(sse.values()) <= MESH_ATLAS_SSE, sse
    assert launches > forced_launches, (launches, forced_launches)
    return dict(wall=wall, sse=sse, launches=launches)


def phase_atlas(dev):
    """The atlas path through pipeline/stages.py: the recipe's CSR counts,
    prepare with the TPM kept sparse on the host, factorize from the CSR
    (the normalized counts reach the card through
    ops.device_densify.to_device_dense), combine, consensus with the TPM
    device-densified on the card and again forced over the device limit
    (override 1: the host-SpMM products and the products-given kernel). The
    forced artifacts must be within ATLAS_FORCED_SSE of the resident ones,
    the device densify of the TPM bit-equal to the native host densify, the
    native library loaded and the products-given kernel within its bound of
    plain at M=100,000 and 20,000. The CD kernels' launches are counted over
    the path (set to 0 before it). Returns the kernel values by M and the
    path's launches."""
    import torch

    from cnmf_tpu_torch import native
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops.device_densify import (
        device_densify_csr,
        device_densify_eligible,
        to_device_dense,
    )
    from cnmf_tpu_torch.pipeline import stages
    from cnmf_tpu_torch.utils.timing import reset_timings, timings

    def sync_wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    assert native.library_loaded(), "the native host library did not load"
    wrappers = {name: getattr(ck, name) for name in
                ("cd_w_half_sweep", "cd_h_half_sweep",
                 "cd_sweep_from_products")}
    t0 = time.perf_counter()
    X = atlas_counts(dev)
    walls = {"synthesize": sync_wall(t0)}
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    reset_timings()

    t0 = time.perf_counter()
    prep = stages.prepare_arrays(X, num_highvar_genes=ATLAS_HVG)
    walls["prepare"] = sync_wall(t0)
    prep_parts = {k.split(".")[1]: round(v[0], 3) for k, v in timings().items()
                  if k.startswith("prepare.")}
    norm_route = ("device" if device_densify_eligible(prep.norm, np.float32,
                                                      dev) else "host")
    kwargs = stages.nmf_run_params()
    _, seeds = stages.replicate_seeds([ATLAS_K], ATLAS_RESTARTS, 14)
    t0 = time.perf_counter()
    Xd = to_device_dense(prep.norm, np.float32, dev)
    walls["norm_to_device"] = sync_wall(t0)
    t0 = time.perf_counter()
    spectra, n_iter, executed = stages.factorize_k(prep.norm, Xd, ATLAS_K,
                                                   seeds, kwargs)
    walls["factorize"] = sync_wall(t0)
    fact_launches = {k: fn.launches for k, fn in wrappers.items()}
    t0 = time.perf_counter()
    merged = stages.combine_arrays(list(spectra))
    walls["combine"] = sync_wall(t0)

    # the TPM on the card by each route, and the resident consensus
    tpm = prep.tpm
    tpm_route = device_densify_eligible(tpm, np.float32, dev)
    t0 = time.perf_counter()
    tpm_dev = device_densify_csr(tpm, np.float32, dev)
    dev_s = sync_wall(t0)
    t0 = time.perf_counter()
    host = native.densify_csr(tpm, out_dtype=np.float32)
    host_densify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpm_host_dev = torch.as_tensor(host, device=dev)
    upload_s = sync_wall(t0)
    del host
    same_bits = bool(torch.equal(tpm_dev, tpm_host_dev))
    del tpm_host_dev
    sparse_bytes = tpm.data.nbytes + tpm.indices.nbytes + tpm.indptr.nbytes
    dense_bytes = tpm.shape[0] * tpm.shape[1] * 4
    limit = stages.tpm_device_limit(dev)
    assert stages.tpm_fits_device(tpm.shape, dev), (tpm.shape, limit)
    assert not stages.tpm_fits_device(tpm.shape, dev, override=1)

    # the resident consensus runs as one program (the CUDA default); its
    # own peak device memory apart from the path's
    results, subs = {}, {}
    path_peak = torch.cuda.max_memory_allocated()
    for branch, tpm_src in (("resident", tpm_dev), ("forced", tpm)):
        subs[branch] = {}
        launches0 = ck.cd_sweep_from_products.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results[branch] = stages.consensus_arrays(
            merged, ATLAS_K, Xd, tpm_src, prep.tpm_std, prep.hvg_idx, kwargs,
            density_threshold=0.5, zero_safe=True, timings=subs[branch])
        walls["consensus_" + branch] = sync_wall(t0)
        subs[branch]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        path_peak = max(path_peak, torch.cuda.max_memory_allocated())
        subs[branch]["products"] = (ck.cd_sweep_from_products.launches
                                             - launches0)
        del tpm_src
    del tpm_dev
    peak_gb = path_peak / 1e9
    launches = {k: fn.launches for k, fn in wrappers.items()}
    sse = {name: rel_sse(getattr(results["forced"], name),
                         getattr(results["resident"], name))
           for name in ("spectra_tpm", "spectra_score", "usages")}
    forced = results["forced"]
    for name in ("spectra", "usages", "spectra_tpm", "spectra_score"):
        assert np.isfinite(getattr(forced, name)).all(), name
    assert forced.spectra_tpm.shape == (ATLAS_K, ATLAS_GENES)
    assert forced.usages.shape == (ATLAS_CELLS, ATLAS_K)
    phase_mesh_atlas(dev, merged, Xd, prep, kwargs, forced,
                     walls["consensus_forced"],
                     subs["forced"]["products"])
    kernel = phase_atlas_products_kernel(dev, (ATLAS_CELLS, ATLAS_GENES))
    fused = phase_atlas_fused_kernels(Xd, -(-ATLAS_RESTARTS // 8) * 8,
                                      16 - ATLAS_K)
    stop_rule = phase_atlas_stop_rule(prep.norm, Xd, seeds, kwargs, n_iter)

    def secs(d):
        return ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in d.items())

    print(f"[atlas] {ATLAS_CELLS}x{ATLAS_GENES} counts (synthesize's recipe, "
          f"k_true {ATLAS_K_TRUE}, h_density {ATLAS_H_DENSITY}): {X.nnz} "
          f"nonzeros, fill {X.nnz / (ATLAS_CELLS * ATLAS_GENES):.4f}, drawn on "
          f"the card in {walls['synthesize']:.3f} s; {ATLAS_HVG} HVGs, K="
          f"{ATLAS_K} x {ATLAS_RESTARTS} restarts from the CSR (normalized "
          f"counts to the card by the {norm_route} route in "
          f"{walls['norm_to_device']:.3f} s): walls_s prepare "
          f"{walls['prepare']:.3f} ({secs(prep_parts)}), factorize "
          f"{walls['factorize']:.3f}, combine {walls['combine']:.3f}; sweeps "
          f"max {n_iter.max()} mean {n_iter.mean():.1f}, executed "
          f"restart-sweeps {executed}; factorize launches {fact_launches}",
          flush=True)
    print(f"[atlas] consensus K={ATLAS_K} dt 0.5 "
          f"({int(forced.density_filter.sum())} of {len(merged)} kept): "
          f"resident {walls['consensus_resident']:.3f} s ({secs(subs['resident'])}) "
          f"| forced {walls['consensus_forced']:.3f} s "
          f"({secs(subs['forced'])}); forced vs resident relative SSE "
          + json.dumps({k: float(f"{v:.3e}") for k, v in sse.items()})
          + f" (bound {ATLAS_FORCED_SSE:g}); path launches {launches}",
          flush=True)
    print(f"[atlas] TPM {tpm.shape[0]}x{tpm.shape[1]} (device limit "
          f"{limit / 1e9:.2f} GB): device densify {dev_s:.3f} s shipping "
          f"{sparse_bytes / 1e9:.3f} GB (eligible: {tpm_route}) vs native host "
          f"densify {host_densify_s:.3f} s + upload {upload_s:.3f} s shipping "
          f"{dense_bytes / 1e9:.3f} GB; bit-equal: {same_bits}; native library "
          f"loaded: True; peak device memory {peak_gb:.2f} GB", flush=True)
    print("[atlas] cd_sweep_from_products B=1 K=16 (12 + 4 zero columns): "
          + "; ".join(f"M={M} rel={v['rel']:.3e} kernel_ms="
                      f"{v['ms']:.4f} alone_ms={v['alone_ms']:.4f} plain_ms="
                      f"{v['plain_ms']:.4f} bound_ms={v['bound_ms']:.4f} "
                      f"({v['by']})" for M, v in kernel.items())
          + f"; B={-(-ATLAS_RESTARTS // 8) * 8} K=16 on the path's X: "
          + "; ".join(f"{name} rel={v['rel']:.3e} kernel_ms={v['ms']:.4f} "
                      f"plain_ms={v['plain_ms']:.4f} bound_ms="
                      f"{v['bound_ms']:.4f} ({v['by']})"
                      for name, v in fused.items())
          + "; sweeps of restarts 0-1 without the ladder "
          + json.dumps(stop_rule), flush=True)
    assert same_bits, "device densify differs from the host densify"
    assert max(sse.values()) <= ATLAS_FORCED_SSE, sse
    assert all(n > 0 for n in launches.values()), launches
    assert subs["forced"]["products"] > 0, subs
    return kernel, launches


# the [mesh] phase: the sharded code paths as two shards on one card (a
# mesh of ["cuda", "cuda"]: the same card twice, as the JAX tests' virtual
# devices on one CPU). Two shards on one card measure no multi-card speed.
MESH_SHARDS = 2
MESH_SSE = 1e-4          # sharded against single-device consensus, rel SSE
MESH_ATLAS_SSE = 1e-8    # row-sharded forced atlas against unsharded, rel SSE
MESH_KERNELS = ("cd_w_half_sweep", "cd_h_half_sweep", "cd_sweep_from_products",
                "kl_mu_w_numerator", "kl_mu_h_numerator", "kl_x_log_wh",
                "beta_mu_w_terms", "beta_mu_h_terms")


def mesh_wrappers():
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk

    return {name: getattr(ck if name.startswith("cd_") else mk, name)
            for name in MESH_KERNELS}


def consensus_gap(a, b):
    """Largest relative SSE of the consensus spectra and usages of two runs
    (b the reference)."""
    return max(rel_sse(getattr(a, n), getattr(b, n))
               for n in ("spectra", "usages"))


def phase_mesh_products_kernel(Xd, mesh_devices, K=16, B=100):
    """The cell axis' H half at the main path's shape: partial products
    XᵀW and WᵀW on each shard (torch.matmul), summed, then
    cd_sweep_from_products at (B, M=G, K) against its plain version. Returns
    the kernel's values and the partial product's and the shard sum's ms."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops.kernel_lib import kernel_function, raise_on
    from cnmf_tpu_torch.parallel.collectives import sum_shards
    from cnmf_tpu_torch.parallel.mesh import put_cells

    N, G = Xd.shape
    g = torch.Generator(device=Xd.device).manual_seed(9)
    avg = float(torch.sqrt(Xd.mean() / K))
    Xs = put_cells(Xd, mesh_devices)
    Ws = [avg * torch.randn(B, x.shape[0], K, device=x.device,
                            generator=g).abs() for x in Xs.parts]
    Ht = avg * torch.randn(B, G, K, device=Xd.device, generator=g).abs()
    partials = [ck._shared_xt_dot(x, w) for x, w in zip(Xs.parts, Ws)]
    gram = sum_shards([ck._gram(w) for w in Ws])
    P = sum_shards(partials)
    kernel, plain = ck.cd_sweep_from_products, ck.cd_sweep_from_products_plain
    abs_err, rel_err = compare(kernel(Ht, gram, P), plain(Ht, gram, P))
    assert rel_err <= KERNEL_REL_BOUND, ("mesh products", rel_err)
    res, part = torch.empty_like(Ht), torch.empty((G, B), device=Xd.device)
    launch = kernel_function("cd_half_sweep_products", ck._PRODUCTS_ARGS)
    ptrs = (P.data_ptr(), G, Ht.data_ptr(), gram.data_ptr(), 0.0, B, K,
            res.data_ptr(), part.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    bound_ms, by = bound(2 * G * K * K * B, 4 * (3 * B * G * K + B * K * K))
    return dict(rel=rel_err, abs=abs_err,
                ms=timed_ms(lambda: kernel(Ht, gram, P)),
                alone_ms=device_ms(lambda: raise_on("products", launch(*ptrs))),
                plain_ms=timed_ms(lambda: plain(Ht, gram, P)),
                bound_ms=bound_ms, by=by,
                matmul_ms=timed_ms(lambda: ck._shared_xt_dot(Xs.parts[0],
                                                             Ws[0])),
                sum_ms=timed_ms(lambda: sum_shards(partials)),
                sum_mb=sum(p.numel() * 4 for p in partials) / 1e6)


def phase_mesh_shard_kernels(X_host, Xd, devices, k, seeds, cd):
    """Every kernel the mesh paths launch, against its plain version at the
    shapes a shard gives it, on the main path's X and the restarts' own
    inits at K=k (the bucket of 16: zero columns past k): shard 0's rows of
    the cell axis (B=100, N=2700/2) for the W half, the KL numerators and
    divergence and the Itakura-Saito terms; a restart group's first ladder
    rung (50 restarts a group: B=the rung, all N) for the CD halves and the
    KL kernels. Returns {case: rel}, each within KERNEL_REL_BOUND."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.parallel.mesh import put_cells
    from cnmf_tpu_torch.pipeline import solvers, stages

    pad = ((0, 0), (0, 0), (0, 16 - k))
    W0, Ht0 = (torch.as_tensor(np.pad(f, pad), device=Xd.device)
               for f in stages.restart_inits(X_host, k, seeds, "random",
                                             np.float32))
    x = put_cells(X_host, devices).parts[0]
    w = W0[:, :x.shape[0]].contiguous()
    rung = solvers.ladder_rungs(Xd, len(seeds) // MESH_SHARDS, 16, cd)[0]
    Wr, Htr = W0[:rung].contiguous(), Ht0[:rung].contiguous()
    regs = dict(l1_reg=0.0, l2_reg=0.0)
    cases = {
        "cd_w cell": (ck.cd_w_half_sweep, ck.cd_w_half_sweep_plain,
                      (x, w, Ht0), regs),
        "kl_w cell": (mk.kl_mu_w_numerator, mk.kl_mu_w_numerator_plain,
                      (x, w, Ht0), {}),
        "kl_h cell": (mk.kl_mu_h_numerator, mk.kl_mu_h_numerator_plain,
                      (x, w, Ht0), {}),
        "xlogwh cell": (mk.kl_x_log_wh, mk.kl_x_log_wh_plain, (x, w, Ht0),
                        {}),
        "is_w cell": (mk.beta_mu_w_terms, mk.beta_mu_w_terms_plain,
                      (x, w, Ht0, 0.0), {}),
        "is_h cell": (mk.beta_mu_h_terms, mk.beta_mu_h_terms_plain,
                      (x, w, Ht0, 0.0), {}),
        "cd_w rung": (ck.cd_w_half_sweep, ck.cd_w_half_sweep_plain,
                      (Xd, Wr, Htr), regs),
        "cd_h rung": (ck.cd_h_half_sweep, ck.cd_h_half_sweep_plain,
                      (Xd, Wr, Htr), regs),
        "kl_w rung": (mk.kl_mu_w_numerator, mk.kl_mu_w_numerator_plain,
                      (Xd, Wr, Htr), {}),
        "kl_h rung": (mk.kl_mu_h_numerator, mk.kl_mu_h_numerator_plain,
                      (Xd, Wr, Htr), {}),
        "xlogwh rung": (mk.kl_x_log_wh, mk.kl_x_log_wh_plain, (Xd, Wr, Htr),
                        {}),
    }
    rels = {}
    for case, (kernel, plain, args, kw) in cases.items():
        rels[case] = compare(kernel(*args, **kw), plain(*args, **kw))[1]
    assert max(rels.values()) <= KERNEL_REL_BOUND, rels
    return rels, x.shape[0], rung


def phase_mesh(dev, counts, hvg, ks, n_iter, k_cons, host):
    """The mesh paths of pipeline/solvers.py and pipeline/stages.py on
    MESH_SHARDS shards of one card from the host's inits (the caller sets
    HOST_DRAWS: the seeded mesh paths are phase_seeded's), against the
    single-device path: (a) the restart axis, CD at every K of the main
    path (``host``: phase_seeded's host-drawn single-device factorize, its
    spectra bit for bit and its sweeps, not solved again; the last K profiled on
    one device and on the mesh, wall and device idle share) and KL at
    k_cons (the same sweeps, consensus within MESH_SSE); (b) the cell
    axis at k_cons, CD, KL and Itakura-Saito (consensus within MESH_SSE),
    and cd_sweep_from_products at the cell axis' H half (B=100, M=G, K=16)
    against plain; (c) consensus on cell-sharded normalized counts and TPM
    (within MESH_SSE). The single-device references run first; then the
    kernels' launch counts are set to 0, the mesh runs (a)-(c) go, and the
    counts are read just after them: each of MESH_KERNELS must launch
    (printed in MESH_KERNELS' order). Then every kernel the mesh paths
    launch is held against plain at a shard's shapes
    (phase_mesh_shard_kernels). Returns the products kernel's values and
    the launches."""
    import torch

    from cnmf_tpu_torch.parallel.mesh import build_mesh, put_cells
    from cnmf_tpu_torch.pipeline import stages

    def wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prep = stages.prepare_arrays(counts, num_highvar_genes=hvg)
    X_host = np.ascontiguousarray(prep.norm, dtype=np.float32)
    Xd = torch.as_tensor(X_host, device=dev)
    tpm_host = np.ascontiguousarray(prep.tpm, dtype=np.float32)
    tpm = torch.as_tensor(tpm_host, device=dev)
    cd, kl, is_ = (stages.nmf_run_params(),
                   stages.nmf_run_params(beta_loss="kullback-leibler",
                                         max_iter=200),
                   stages.nmf_run_params(beta_loss="itakura-saito",
                                         max_iter=200))
    dts = {"cd": 0.5, "kl": 0.5, "is": IS_DENSITY_THRESHOLD}
    grid, seeds = stages.replicate_seeds(ks, n_iter, 14)
    seeds_k = {k: seeds[[i for i, (kk, _) in enumerate(grid) if kk == k]]
               for k in ks}
    mu_seeds = stages.replicate_seeds([k_cons], n_iter, 14)[1]
    devices = [dev] * MESH_SHARDS
    restart_mesh = build_mesh(devices, cell_axis=1)
    cell_mesh = build_mesh(devices, cell_axis=MESH_SHARDS)

    def consensus(spec, loss, kwargs, norm=Xd, tpm_src=tpm):
        merged = spec if spec.ndim == 2 else stages.combine_arrays(list(spec))
        return stages.consensus_arrays(merged, k_cons, norm, tpm_src,
                                       prep.tpm_std, prep.hvg_idx, kwargs,
                                       density_threshold=dts[loss])

    # the single-device references this phase needs besides [seeded]'s
    kl_spec, kl_n, _ = stages.factorize_k(X_host, Xd, k_cons, mu_seeds, kl)
    is_spec = stages.factorize_k(X_host, Xd, k_cons, mu_seeds, is_)[0]
    ref = {"cd": consensus(host["spectra"][k_cons], "cd", cd),
           "kl": consensus(kl_spec, "kl", kl),
           "is": consensus(is_spec, "is", is_)}
    idle = {}
    _, w, busy, _ = profiled(lambda: stages.factorize_k(
        X_host, Xd, ks[-1], seeds_k[ks[-1]], cd))
    idle["single"] = (w, 1 - busy / w)

    # the mesh runs, their launches counted
    wrappers = mesh_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    same_bits, same_sweeps = True, True
    for k in ks:
        spec, n_it, _ = stages.factorize_k(X_host, Xd, k, seeds_k[k], cd,
                                           mesh=restart_mesh)
        same_bits &= np.array_equal(spec, host["spectra"][k])
        same_sweeps &= np.array_equal(n_it, host["sweeps"][k])
    restart_cd_s = wall(t0)
    _, w, busy, _ = profiled(lambda: stages.factorize_k(
        X_host, Xd, ks[-1], seeds_k[ks[-1]], cd, mesh=restart_mesh))
    idle["restart"] = (w, 1 - busy / w)
    t0 = time.perf_counter()
    kl_spec_r, kl_n_r, _ = stages.factorize_k(X_host, Xd, k_cons, mu_seeds,
                                              kl, mesh=restart_mesh)
    restart_kl_s = wall(t0)
    cell = {}
    for loss, kwargs, run_seeds in (("cd", cd, seeds_k[k_cons]),
                                    ("kl", kl, mu_seeds),
                                    ("is", is_, mu_seeds)):
        t0 = time.perf_counter()
        spec, n_it, _ = stages.factorize_k(X_host, Xd, k_cons, run_seeds,
                                           kwargs, mesh=cell_mesh)
        cell[loss] = (spec, n_it, wall(t0))
    t0 = time.perf_counter()
    sharded = consensus(host["spectra"][k_cons], "cd", cd,
                        put_cells(X_host, devices),
                        put_cells(tpm_host, devices))
    sharded_s = wall(t0)
    launches = {name: fn.launches for name, fn in wrappers.items()}

    # the checks, on one device
    gaps = {"restart_kl": consensus_gap(consensus(kl_spec_r, "kl", kl),
                                        ref["kl"])}
    for loss, kwargs in (("cd", cd), ("kl", kl), ("is", is_)):
        gaps["cell_" + loss] = consensus_gap(
            consensus(cell[loss][0], loss, kwargs), ref[loss])
    gaps["shard_cells"] = max(
        consensus_gap(sharded, ref["cd"]),
        *(rel_sse(getattr(sharded, n), getattr(ref["cd"], n))
          for n in ("spectra_tpm", "spectra_score")))
    kl_gap = float(np.max(np.abs(kl_spec_r - kl_spec))
                   / np.max(np.abs(kl_spec)))
    shard_rels, shard_n, rung = phase_mesh_shard_kernels(
        X_host, Xd, devices, k_cons, mu_seeds, cd)
    kernel = phase_mesh_products_kernel(Xd, devices)
    main_cd = host["sweeps"][k_cons]
    cell_text = "; ".join(
        f"{loss.upper()} {c[2]:.3f} s, sweeps {c[1].max()}/{c[1].mean():.1f}"
        for loss, c in cell.items())
    print(f"[mesh] {MESH_SHARDS} shards on the card. (a) restart: CD K="
          f"{ks[0]}..{ks[-1]} x {n_iter} {restart_cd_s:.3f} s (single "
          f"{host['walls'][0]:.3f}), bits equal {same_bits}, sweeps equal "
          f"{same_sweeps}"
          f"; profiled K={ks[-1]} wall/idle single {idle['single'][0]:.3f} s/"
          f"{idle['single'][1]:.1%}, restart {idle['restart'][0]:.3f} s/"
          f"{idle['restart'][1]:.1%}; KL K={k_cons} {restart_kl_s:.3f} s, "
          f"sweeps equal "
          f"{np.array_equal(kl_n_r, kl_n)}, max rel gap {kl_gap:.1e}. (b) "
          f"cell K={k_cons}: {cell_text} (single CD "
          + f"{main_cd.max()}/{main_cd.mean():.1f}, KL {kl_n.max()}/"
          f"{kl_n.mean():.1f}). (c) shard_cells "
          f"consensus {sharded_s:.3f} s. rel SSE "
          + json.dumps({k: float(f"{v:.1e}") for k, v in gaps.items()})
          + f" (bound {MESH_SSE:g}); launches "
          + json.dumps(list(launches.values()), separators=(",", ":")),
          flush=True)
    worst = max(shard_rels, key=shard_rels.get)
    print(f"[mesh] kernels vs plain at shard shapes (cell N={shard_n} B={n_iter},"
          f" rung B={rung} N={Xd.shape[0]}), {len(shard_rels)} cases, max rel "
          f"{shard_rels[worst]:.1e} ({worst})", flush=True)
    print(f"[mesh] cell H half B=100 M={Xd.shape[1]} K=16: products "
          f"rel={kernel['rel']:.2e} kernel/alone/plain/bound ms "
          f"{kernel['ms']:.4f}/{kernel['alone_ms']:.4f}/"
          f"{kernel['plain_ms']:.4f}/{kernel['bound_ms']:.4f} "
          f"({kernel['by']}); XtW a shard {kernel['matmul_ms']:.4f} ms, shard "
          f"sum {kernel['sum_ms']:.4f} ms for {kernel['sum_mb']:.1f} MB",
          flush=True)
    assert same_bits and same_sweeps, "restart axis left the single device"
    assert np.array_equal(kl_n_r, kl_n), "KL restart axis sweeps"
    assert max(gaps.values()) <= MESH_SSE, gaps
    assert all(n > 0 for n in launches.values()), launches
    return kernel, launches


# what each bool template argument of a kernel family selects, (false,
# true) in the arguments' order
IS_TAG, SIDE_TAG = ("beta", "IS"), ("W", "H")
BOOL_TAGS = {"beta_terms_kernel": (IS_TAG, ("1", "S")),
             "kl_x_log_wh_kernel": (("1", "S"),),
             "cd_fused_kernel": (SIDE_TAG,),
             "kl_numerator_tiled_kernel": (SIDE_TAG,),
             "beta_terms_tiled_kernel": (IS_TAG, SIDE_TAG)}


def template_tag(fam, args):
    """An instantiation's tag from its mangled template arguments, (int,
    '') or ('', bool digit) pairs: the ints, then each bool by its name."""
    flags = iter(BOOL_TAGS.get(fam, ()))
    return ",".join(a or next(flags, ("0", "1"))[int(b)] for a, b in args)


def ptxas_lines(log_path):
    """The build log's kernel families: each one's instantiations'
    registers (least and most), one line for the families where no
    instantiation keeps a stack frame or spills, and a line for each other
    family with each such instantiation's registers, stack frame and spill
    bytes."""
    fams, name = {}, None
    with open(log_path) as fh:
        for ln in fh:
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                mangled = m.group(1)
                fam = re.search(r"\d+([a-z_]+(?:kernel|wide)\w*?)(?:I|E|v)",
                                mangled)
                args = re.findall(r"Li(\d+)E|Lb([01])E", mangled)
                fam = fam.group(1) if fam else mangled
                tag = template_tag(fam, args) or "-"
                name = (fam, tag)
                fams.setdefault(name[0], {})[tag] = ["?", "?", "?"]
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
            if m:
                fams[name[0]][name[1]][1:] = [m.group(1), m.group(2)]
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                fams[name[0]][name[1]][0] = m.group(1)
    lines, clean = [], []
    for fam, tags in fams.items():
        regs = [int(v[0]) for v in tags.values() if v[0].isdigit()]
        span = f"{min(regs, default=0)}-{max(regs, default=0)}"
        stack = " ".join(
            f"{tag}:{'/'.join(v)}" for tag, v in sorted(
                tags.items(), key=lambda kv: [int(x) if x.isdigit() else 0
                                              for x in kv[0].split(",")])
            if v[1:] != ["0", "0"])
        if stack:
            lines.append(f"[ptxas] {fam}: {len(tags)} builds, registers "
                         f"{span}; stack/spill bytes: {stack}")
        else:
            clean.append(f"{fam} {len(tags)}, {span}")
    return (["[ptxas] no stack frame or spill (builds, registers): "
             + "; ".join(clean)] if clean else []) + lines


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
          "missing: " + (", ".join(m for m, ok in have.items() if not ok)
                         or "none"), flush=True)

    # 2. build
    from cnmf_tpu_torch.ops import cd_kernels as ck
    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.ops.kernel_lib import load_library
    from cnmf_tpu_torch.pipeline import stages

    counts, warm, built = phase_autowarm(dev)
    lib = load_library()
    print(f"[build] {os.path.relpath(lib.so_path)} in {built:.2f} s on the "
          "autowarm's thread", flush=True)
    for line in ptxas_lines(lib.so_path + ".log"):
        print(line, flush=True)

    # 3. kernels against plain, then the small slices against the CPU
    print(f"[kernel] rel = max|kernel-plain|/max|plain| <= "
          f"{KERNEL_REL_BOUND:g}, abs = max|kernel-plain| (f32); K0: zero K "
          "columns; of_bound = bound/kernel ms", flush=True)
    records = phase_kernels(dev)
    records.update(phase_mu_kernels(dev))
    kl_kwargs = stages.nmf_run_params(beta_loss="kullback-leibler",
                                      max_iter=200)
    is_kwargs = stages.nmf_run_params(beta_loss="itakura-saito", max_iter=200)
    phase_small_agreement(dev)
    phase_small_agreement(dev, kl_kwargs, "kullback-leibler")
    phase_small_agreement(dev, is_kwargs, "itakura-saito")

    # 4. the main path at PBMC-3k scale
    ks, n_iter, hvg, k_cons = list(range(5, 14)), 100, 2000, 10
    wrappers = {"cd_w_half_sweep": ck.cd_w_half_sweep,
                "cd_h_half_sweep": ck.cd_h_half_sweep,
                "cd_sweep_from_products": ck.cd_sweep_from_products}
    for fn in wrappers.values():
        fn.launches = 0
    missing = [m for m in ("pandas", "h5py", "yaml") if not have[m]]
    if not missing:
        route = "cNMF(device='cuda') with its run directory"
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as workdir:
            walls, usage, merged, Xd = run_cnmf(counts, ks, n_iter, hvg,
                                                k_cons, workdir)
    else:
        route = f"stages.py ({', '.join(missing)} missing)"
        walls, merged, result, _, Xd, _ = run_stages(
            counts, ks, n_iter, hvg, k_cons, dev)
        usage = check_result(result, k_cons, hvg)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    assert np.allclose(usage.sum(axis=1), 1.0), "usage rows must sum to 1"
    print(f"[slice] 2700x10000 counts, {hvg} HVGs, K={ks[0]}..{ks[-1]} x "
          f"{n_iter} restarts, consensus K={k_cons} dt 0.5, via {route}: "
          "walls_s " + json.dumps({k: round(v, 3) for k, v in walls.items()},
                                  separators=(",", ":"))
          + "; launches W/H/products " + "/".join(map(str, launches.values())),
          flush=True)
    assert all(n > 0 for n in launches.values()), launches

    # 5. k-selection over the CD slice's merged spectra, the one-program
    # consensus against the step-by-step one, the compact integer TPM
    phase_k_selection(merged, Xd)
    fused_launches = {"cd": phase_fused(
        "CD", merged[k_cons], counts, hvg, k_cons, dev,
        stages.nmf_run_params(), {"cd_sweep_from_products":
                                  ck.cd_sweep_from_products})}
    del Xd
    phase_drain(dev, counts, hvg, ks, n_iter, k_cons, merged, wrappers)
    del merged
    phase_device_tpm(dev, counts, hvg, ks, n_iter)

    # 6. the threefry-seeded paths against the host's draws, then the mesh
    # paths from the host's draws on two shards of the card
    host = phase_seeded(dev, counts, hvg, ks, n_iter, k_cons)
    with host_draws():
        mesh_kernel, mesh_launches = phase_mesh(
            dev, counts, hvg, ks, n_iter, k_cons, host)
    del host

    # 7. the CD factorize on each schedule, the MU ladder's rungs, the
    # batch check and the tail-compacting schedules
    X_host, Xd = path_input(counts, hvg, dev)
    phase_schedules(X_host, Xd, ks, n_iter, stages.nmf_run_params(), "CD")
    phase_ladder_tilings(Xd, k_cons)
    phase_batch(dev)
    sched_launches = phase_sched(counts, hvg, X_host, Xd, ks, n_iter,
                                 k_cons, warm)

    # 8. the KL path and 9. the Itakura-Saito path at bench.py's KL
    # configuration, each factorize again plain and on the ladder
    part, launches_b1, kl_spectra = mu_slice("kl", counts, k_cons, n_iter,
                                             hvg, dev, kl_kwargs, KL_KERNELS)
    launches.update(part)
    fused_launches["kl"] = phase_fused(
        "KL", kl_spectra, counts, hvg, k_cons, dev, kl_kwargs,
        {name: getattr(mk, name) for name in KL_KERNELS})
    phase_schedules(X_host, Xd, [k_cons], n_iter, kl_kwargs, "KL")
    phase_profile_refits(counts, hvg, dev, kl_spectra, k_cons,
                         kl_kwargs, 0.5, "KL", "kl_x_log_wh", k_stats=False)
    part, b1, is_spectra = mu_slice("is", counts, k_cons, n_iter, hvg, dev,
                                    is_kwargs, BETA_KERNELS,
                                    k_stats=[k_cons],
                                    density_threshold=IS_DENSITY_THRESHOLD)
    launches.update(part)
    launches_b1.update(b1)
    fused_launches["is"] = phase_fused(
        "IS", is_spectra, counts, hvg, k_cons, dev, is_kwargs,
        {name: getattr(mk, name) for name in BETA_KERNELS},
        density_threshold=IS_DENSITY_THRESHOLD)
    phase_schedules(X_host, Xd, [k_cons], n_iter, is_kwargs, "IS")
    phase_profile_refits(counts, hvg, dev, is_spectra, k_cons,
                         is_kwargs, IS_DENSITY_THRESHOLD, "IS",
                         "beta_mu_w_terms")

    # 10. Preprocess with Harmony, and cNMF on its output
    phase_preprocess(dev)

    # 11. the atlas path: sparse counts at 100,000 x 20,000, the TPM on the
    # card and over the device limit
    atlas_kernel, atlas_launches = phase_atlas(dev)
    for M, v in atlas_kernel.items():
        records["cd_sweep_from_products"].update({
            f"{key}_atlas_m{M}": float(f"{v[key]:.4g}")
            for key in ("ms", "alone_ms", "plain_ms", "bound_ms")})
    records["cd_sweep_from_products"].update({
        f"{key}_cells": float(f"{mesh_kernel[key]:.4g}")
        for key in ("ms", "alone_ms", "plain_ms", "bound_ms")})

    # 12. results
    replaces = {"cd_w_half_sweep": "cnmf_tpu/ops/pallas_cd.py:118",
                "cd_h_half_sweep": "cnmf_tpu/ops/pallas_cd.py:162",
                "cd_sweep_from_products": "cnmf_tpu/ops/pallas_cd.py:58",
                "kl_mu_w_numerator": "cnmf_tpu/ops/pallas_mu.py:89",
                "kl_mu_h_numerator": "cnmf_tpu/ops/pallas_mu.py:394",
                "kl_x_log_wh": "cnmf_tpu/ops/pallas_mu.py:357",
                "beta_mu_w_terms": "cnmf_tpu/ops/pallas_mu.py:198",
                "beta_mu_h_terms": "cnmf_tpu/ops/pallas_mu.py:281"}
    sources = {name: "cnmf_tpu_torch/csrc/" + (
        "mu_kl.cu" if name in KL_KERNELS else
        "mu_beta.cu" if name in BETA_KERNELS else "cd_half_sweep.cu")
        for name in replaces}
    # launches in one one-program consensus of each slice, by kernel
    fused = {}
    for part in fused_launches.values():
        for name, n in part.items():
            fused[name] = fused.get(name, 0) + n
    # no single PyTorch call computes any of these functions; measured
    # values to 4 significant digits, well inside their run-to-run spread
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=sources[name],
             replaces=replaces[name], launches=launches[name],
             **({"launches_b1": launches_b1[name]} if name in launches_b1
                else {}),
             **({"launches_atlas": atlas_launches[name]}
                if name in atlas_launches else {}),
             **({"launches_mesh": mesh_launches[name]}
                if name in mesh_launches else {}),
             **({"launches_fused": fused[name]} if name in fused else {}),
             **({"launches_sched": sched_launches[name]}
                if name in sched_launches else {}),
             library_ms=None,
             **{key: float(f"{v:.4g}") if isinstance(v, float) else v
                for key, v in records[name].items()})
        for name in replaces
    ]}, separators=(",", ":")))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
