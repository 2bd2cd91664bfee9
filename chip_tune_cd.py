#!/usr/bin/env python3
"""Times a restart-tiled kernel of the port against other versions of it on
one CUDA card, and checks that every version gives the tree's bits.

    python3 chip_tune_cd.py [--kernel cd|kl|beta|xlogwh]
                            [--against NAME=CSRC_DIR ...] [--rounds 10]

Builds this checkout's source of the kernel ("tree") and the same file of
every --against directory (an earlier csrc/, or a copy with other tilings,
with the same C entry point), one nvcc per build, all started together.
Each build then runs every case on the same inputs: its result must be
within 1e-4 of the plain PyTorch version and have the same bits as the
tree's. Then the builds are timed in turns, the order reversed every round,
with CUDA events around LAUNCHES launches into buffers allocated once.

--kernel cd (the default): the fused CD half-sweep (csrc/cd_half_sweep.cu)
at chip_smoke.py's main shape (B=100 restarts, N=2700 cells, G=2000 genes)
and every register bucket K = 8..64 (K=8 with 3 zero columns), W and H
half; the violations are compared by value (their summation order may
differ), the factor by bits.

--kernel kl: the KL multiplicative-update numerator (csrc/mu_kl.cu,
mu_kl_numerator) on X like normalized counts (a third of it zero): the
factorize shape at K=16 and 8 (3 zero columns), W and H side; the two B=1
consensus refits (row-major X, and X a transposed view); B=13 and 17 with G
not a multiple of 4 (4-byte staging); bucket 24 and the wide K=72.

--kernel beta: the general-beta terms (csrc/mu_beta.cu, mu_beta_terms) at
beta 0 (Itakura-Saito) and 1.5 on the cases of --kernel kl, the ragged ones
at N=2700 so that B=13 and 17 are not split, and small grids (K=16 B=9,
K=8 B=25 and 49: 0.48, 0.57 and 1.06 waves of the restart-tiled kernel on
an H100), about where the library stops choosing it. Where
ops/mu_kernels.py's split_plan splits the contraction (the B=1 refits)
the tree runs mu_beta_terms_split and every other build mu_beta_terms: the
tree's result must have the same bits on two launches and be within 1e-6
of each other build's in norm (‖a − b‖ / ‖b‖); the line also gives each
build's largest difference from the float64 plain version, relative to
its largest value. Every unsplit case must have the tree's bits.

--kernel xlogwh: the KL divergence term (csrc/mu_kl.cu, mu_kl_x_log_wh) on
the W-side cases of --kernel kl, the restart-tiled kernel's edge (B=97 at
K=16 and 8: a partial restart group, G not a multiple of 4; B=33 at K=16,
half of whose lanes would be empty, runs the one-row kernel), and the
factorize and both refits again on the KL path's own X
(pipeline/stages.prepare_arrays of bench.py's counts: the normalized
counts, 27 % of them > eps, and the TPM as the spectra refit's transposed
view). Results are compared by value, per restart: every build within
1e-6 of the float64 plain version and within 2e-7 of the tree's; where
split_plan splits the contraction the tree runs mu_kl_x_log_wh_split (every
other build mu_kl_x_log_wh) and must give the same bits on two launches.
Also prints how many blocks of the one-row kernel's split build an SM
holds at every bucket, and each case's bound (chip_smoke.kernel_work on
its X).

Prints the registers and spills of every build, the instruction mix of the
tree's main loop at K=8 and 16 (cuobjdump), one line per case with every
build's median ms per launch and the tree's grid (blocks, restarts per
block, blocks per SM, waves on the card's SMs, and a split's slices), and
the card's name and power limit. Exits 1 if a check failed.
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np

CD_BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64)
ZERO_COLS = {8: 3}                # the main path's K=5..8 run bucket 8
SHAPE = dict(B=100, N=2700, G=2000)
# (label, B, N, G, K, zero K columns, side, X a transposed view of a (G, N)
# buffer): the KL factorize's buckets, its consensus refits (W side only),
# restarts off the tiled kernel's restart groups with X's pitch not a
# multiple of 4, and two buckets whose code this kernel does not change
KL_CASES = [("factorize", 100, 2700, 2000, K, ZERO_COLS.get(K, 0), side, False)
            for K in (16, 8) for side in "WH"] + [
    ("usage refit", 1, 2700, 2000, 16, 0, "W", False),
    ("spectra refit", 1, 10000, 2700, 16, 0, "W", True),
    ("ragged", 13, 522, 97, 8, 2, "W", False),
    ("ragged", 13, 522, 97, 8, 2, "H", False),
    ("ragged", 17, 450, 333, 16, 2, "W", False),
    ("ragged", 17, 450, 333, 16, 2, "H", False),
    ("ragged", 13, 301, 129, 16, 2, "H", False),
    ("ragged", 17, 389, 271, 8, 2, "W", False),
    ("bucket 24", 20, 2700, 2000, 24, 0, "W", False),
    ("bucket 24", 20, 2700, 2000, 24, 0, "H", False),
    ("wide", 10, 2700, 2000, 72, 0, "W", False),
    ("wide", 10, 2700, 2000, 72, 0, "H", False)]
# (label, B, N, G, K, zero K columns, side, X a view): --kernel beta's cases
BETA_CASES = [c for c in KL_CASES if c[0] != "ragged"] + [
    ("ragged", 13, 2700, 1999, 8, 2, "W", False),
    ("ragged", 17, 2700, 1999, 16, 2, "H", False),
    ("ragged", 13, 2701, 1999, 16, 2, "W", False),
    ("ragged", 17, 2701, 1998, 8, 2, "H", False),
    ("small grid", 9, 2700, 2000, 16, 0, "W", False),
    ("small grid", 25, 2700, 2000, 8, 3, "W", False),
    ("small grid", 49, 2700, 2000, 8, 3, "W", False)]
BETAS = (0.0, 1.5)
# (label, B, N, G, K, zero K columns, X a transposed view, X's source):
# --kernel xlogwh's cases, W side only; "synthetic" X as --kernel kl makes
# it, "path" the KL path's own (the spectra refit's: the TPM)
XLW_CASES = [c[:6] + (c[7], "synthetic") for c in KL_CASES if c[6] == "W"] + [
    ("tiled edge", 33, 2701, 1999, 16, 2, False, "synthetic"),
    ("tiled edge", 97, 2701, 1999, 16, 2, False, "synthetic"),
    ("tiled edge", 97, 2701, 1999, 8, 2, False, "synthetic"),
    ("factorize", 100, 2700, 2000, 16, 0, False, "path"),
    ("factorize", 100, 2700, 2000, 8, 3, False, "path"),
    ("usage refit", 1, 2700, 2000, 16, 0, False, "path"),
    ("spectra refit", 1, 10000, 2700, 16, 0, True, "path")]
LAUNCHES = 5
REL_BOUND = 1e-4
SPLIT_BOUND = 1e-6   # a split launch against the unsplit one, in norm
XLW_EXACT = 1e-6     # the divergence term against float64 plain, per restart
XLW_BUILDS = 2e-7    # ... and against the tree's, per restart
# the kernel's source file, the kernel family whose main loop is reported
# and the families whose ptxas lines are
KERNELS = {"cd": ("cd_half_sweep.cu", "cd_fused_kernel", ("cd_fused_kernel",)),
           "kl": ("mu_kl.cu", "kl_numerator_tiled_kernel",
                  ("kl_numerator_tiled_kernel",)),
           "beta": ("mu_beta.cu", "beta_terms_tiled_kernel",
                    ("beta_terms_tiled_kernel",)),
           "xlogwh": ("mu_kl.cu", "kl_x_log_wh_tiled_kernel",
                      ("kl_x_log_wh_tiled_kernel", "kl_x_log_wh_kernel"))}


def loop_mix(so_path, family, K):
    """The instruction mix of the family's main loop at bucket K, for each
    value of its bool template arguments (chip_smoke.BOOL_TAGS: W or H, and
    beta or IS; "-" for a family without them): {tag: (instructions, FFMA,
    the five most common other opcodes)} from cuobjdump's SASS. The main
    loop is the backward branch whose body holds the most FFMA; a body
    counts both ways of a branch inside it."""
    from torch.utils.cpp_extension import CUDA_HOME

    from chip_smoke import template_tag

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           so_path], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass):
        m = re.match(rf"\S*{family}ILi{K}E((?:Lb[01]E)*)E", func)
        if not m:
            continue
        ops = [(int(a, 16), op, ln) for ln in func.split("\n") for a, op in
               re.findall(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                          ln)]
        best = (0, [])
        for addr, op, ln in ops:
            tgt = re.search(r"BRA\S*\s+(?:`?\(?)0x([0-9a-f]+)", ln)
            if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
                body = [o for a, o, _ in ops
                        if int(tgt.group(1), 16) <= a <= addr]
                n = sum(o.startswith("FFMA") for o in body)
                best = max(best, (n, body))
        n, body = best
        rest = collections.Counter(o.split(".")[0] for o in body
                                   if not o.startswith("FFMA"))
        bools = [("", b) for b in re.findall(r"Lb([01])E", m.group(1))]
        out[template_tag(family, bools) or "-"] = (len(body), n,
                                                   rest.most_common(5))
    return out


def build_all(sources, out_dir, families):
    """{name: source} -> {name: (so path, ptxas lines of the families)},
    compiled in parallel."""
    from chip_smoke import ptxas_lines
    from cnmf_tpu_torch.ops.kernel_lib import _NVCC_FLAGS, _nvcc

    procs = {}
    for name, src in sources.items():
        so = os.path.join(out_dir, f"lib{families[0]}_{name}.so")
        log = open(so + ".log", "w")
        procs[name] = (so, log, subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-shared", "-o", so, src],
            stdout=log, stderr=subprocess.STDOUT))
    out = {}
    for name, (so, log, proc) in procs.items():
        proc.wait()
        log.close()
        if proc.returncode != 0:
            with open(so + ".log") as fh:
                raise RuntimeError(f"{name}: nvcc failed\n{fh.read()}")
        out[name] = (so, [ln for ln in ptxas_lines(so + ".log")
                          if ln.split()[1] in families])
    return out


def bind(so, symbol, argtypes):
    """The library's entry point, bound with the port's argument types."""
    from cnmf_tpu_torch.ops.kernel_lib import I32

    fn = getattr(ctypes.CDLL(so), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = I32
    return fn


def raising(fn, symbol):
    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return call


def bound_call(fn, *args):
    """fn(*args) as a call of no arguments, the arguments fixed now (a
    lambda in a loop would read the loop's last values when it runs); a
    tensor is passed as its data pointer and kept alive by the call."""
    import torch

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    return lambda: (args, fn(*ptrs))[1]


def cd_cases(sos, sms, failed):
    """The fused CD half-sweep: (label, {build: call}, grid) per bucket and
    half, each build checked against plain and the tree's factor bits."""
    import torch

    from cnmf_tpu_torch.ops import cd_kernels as ck

    fns = {name: raising(bind(so, "cd_half_sweep_fused", ck._FUSED_ARGS),
                         "cd_half_sweep_fused") for name, so in sos.items()}
    tiling = bind(sos["tree"], "cd_fused_tiling", [ctypes.c_int] * 3)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    B, N, G = SHAPE["B"], SHAPE["N"], SHAPE["G"]
    X = torch.as_tensor(rng.gamma(1.0, 1.0, (N, G)).astype(np.float32),
                        device=dev)
    cases = []
    for K in CD_BUCKETS:
        avg = np.sqrt(1.0 / K)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        live = K - ZERO_COLS.get(K, 0)
        W[:, :, live:] = 0.0
        Ht[:, :, live:] = 0.0
        W, Ht = (torch.as_tensor(a, device=dev) for a in (W, Ht))
        for half, transposed in (("W", False), ("H", True)):
            F, Fo = (Ht, W) if transposed else (W, Ht)
            M, C, sxm, sxc = (G, N, 1, G) if transposed else (N, G, G, 1)
            gram = ck._with_l2(ck._gram(Fo), 0.0)
            plain = (ck.cd_h_half_sweep_plain if transposed
                     else ck.cd_w_half_sweep_plain)(X, W, Ht)
            calls, rels, sames, viols = {}, [], [], []
            for name, fn in fns.items():
                out = torch.empty_like(F)
                # a partials row for every row of F, so no build's tiling
                # needs to be read: rows its grid does not write stay 0
                part = torch.zeros((M, B), dtype=torch.float32, device=dev)
                call = bound_call(fn, X, M, C, sxm, sxc, Fo, F, gram, 0.0, B,
                                  K, out, part, None, stream)
                call()
                torch.cuda.synchronize()
                viol = part.sum(dim=0)
                rel = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip((out, viol), plain))
                calls[name] = call
                rels.append(f"{name} {rel:.3e}")
                if name == "tree":
                    ref = (out, viol)
                else:
                    same = bool(torch.equal(out, ref[0]))
                    sames.append(f"{name} {same}")
                    viols.append(f"{name} "
                                 f"{float(((viol - ref[1]).abs() / ref[1]).max()):.3e}")
                    if not same:
                        failed.append(f"K={K} {half} {name}: factor bits differ")
                if rel > REL_BOUND:
                    failed.append(f"K={K} {half} {name}: {rel:.3e} from plain")
            print(f"[tune-check] K={K} {half}: max_rel_diff vs plain "
                  f"{', '.join(rels)}; factor bits equal to tree's: "
                  f"{', '.join(sames) or '-'}; violation max rel diff "
                  f"{', '.join(viols) or '-'}", flush=True)
            grid = [tiling(K, int(transposed), f) for f in range(4)]
            cases.append((f"K={K} {half}", calls, grid_text(grid, B, M, sms)))
    return cases


def kl_cases(sos, sms, failed):
    """The KL numerator: (label, {build: call}, grid) per case of KL_CASES,
    each build checked against plain and the tree's bits."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk
    from cnmf_tpu_torch.ops.kernel_lib import I32, I64

    fns = {name: raising(bind(so, "mu_kl_numerator", mk._ARGS),
                         "mu_kl_numerator") for name, so in sos.items()}
    tiling = bind(sos["tree"], "mu_kl_numerator_tiling",
                  (I32, I32, I64, I64, I32))
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    cases = []
    for label, B, N, G, K, pad, side, view in KL_CASES:
        X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
            np.float32)
        avg = np.sqrt(X.mean() / K)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        X = (torch.as_tensor(np.ascontiguousarray(X.T), device=dev).T if view
             else torch.as_tensor(X, device=dev))
        W, Ht = (torch.as_tensor(a, device=dev) for a in (W, Ht))
        transposed = side == "H"
        F, Fo = (Ht, W) if transposed else (W, Ht)
        M = F.shape[1]
        C, sxm, sxc = mk._x_strides(X, transposed)
        plain = (mk.kl_mu_h_numerator_plain if transposed
                 else mk.kl_mu_w_numerator_plain)(X, W, Ht)
        calls, rels, sames = {}, [], []
        for name, fn in fns.items():
            out = torch.empty_like(F)
            call = bound_call(fn, X, M, C, sxm, sxc, Fo, F, B, K, out, stream)
            call()
            torch.cuda.synchronize()
            rel = float((out - plain).abs().max() / plain.abs().max())
            calls[name] = call
            rels.append(f"{name} {rel:.3e}")
            if name == "tree":
                ref = out
            else:
                same = bool(torch.equal(out, ref))
                sames.append(f"{name} {same}")
                if not same:
                    failed.append(f"{label} K={K} {side} {name}: bits differ")
            if rel > REL_BOUND:
                failed.append(f"{label} K={K} {side} {name}: {rel:.3e} from "
                              "plain")
        tag = f"{label} B={B} N={N} G={G} K={K} {side}"
        print(f"[tune-check] {tag}: max_rel_diff vs plain {', '.join(rels)}; "
              f"bits equal to tree's: {', '.join(sames) or '-'}", flush=True)
        grid = [tiling(K, B, sxm, sxc, f) for f in range(4)]
        cases.append((tag, calls, grid_text(grid, B, M, sms)))
    return cases


def beta_cases(sos, sms, failed):
    """The general-beta terms: (label, {build: call}, grid) per case of
    BETA_CASES and beta, each build checked against plain; unsplit cases
    against the tree's bits, split ones (the tree only) against themselves
    and, in norm, against every other build."""
    import torch

    from cnmf_tpu_torch.ops import mu_kernels as mk
    whole = {name: raising(bind(so, "mu_beta_terms", mk._BETA_ARGS),
                           "mu_beta_terms") for name, so in sos.items()}
    split = raising(bind(sos["tree"], "mu_beta_terms_split",
                         mk._BETA_SPLIT_ARGS), "mu_beta_terms_split")
    tiling = bind(sos["tree"], "mu_beta_terms_tiling", mk._TILING_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    cases = []
    for label, B, N, G, K, pad, side, view in BETA_CASES:
        X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
            np.float32)
        avg = np.sqrt(X.mean() / K)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        X = (torch.as_tensor(np.ascontiguousarray(X.T), device=dev).T if view
             else torch.as_tensor(X, device=dev))
        W, Ht = (torch.as_tensor(a, device=dev) for a in (W, Ht))
        transposed = side == "H"
        F, Fo = (Ht, W) if transposed else (W, Ht)
        M = F.shape[1]
        C, sxm, sxc = mk._x_strides(X, transposed)
        plain_fn = mk.mu_h_terms_plain if transposed else mk.mu_w_terms_plain
        for beta in BETAS:
            # the one-row kernel's rows a block, blocks an SM and split chunk
            one_row = [tiling(K, 1, 1, 1, 1, beta, f) for f in (0, 3, 4)]
            splits, per_split = mk.split_plan(B, M, C, sms, *one_row)
            plain = plain_fn(X, W, Ht, beta)
            exact = (plain_fn(X.double(), W.double(), Ht.double(), beta)
                     if splits > 1 else None)
            calls, rels, sames, notes = {}, [], [], []
            for name, fn in whole.items():
                outs = (torch.empty_like(F), torch.empty_like(F))
                args = (X, M, C, sxm, sxc, Fo, F, B, K, beta)
                if name == "tree" and splits > 1:
                    work = torch.empty((2, splits, *F.shape), dtype=F.dtype,
                                       device=dev)
                    call = bound_call(split, *args, splits, per_split, work,
                                      *outs, stream)
                else:
                    call = bound_call(fn, *args, *outs, stream)
                call()
                torch.cuda.synchronize()
                rel = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(outs, plain))
                calls[name] = call
                rels.append(f"{name} {rel:.3e}")
                if rel > REL_BOUND:
                    failed.append(f"{label} K={K} {side} beta={beta:g} "
                                  f"{name}: {rel:.3e} from plain")
                if exact is not None:
                    err = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(outs, exact))
                    notes.append(f"{name} {err:.3e}")
                if name == "tree":
                    ref = [o.clone() for o in outs]
                    if splits > 1:
                        call()
                        torch.cuda.synchronize()
                        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
                        sames.append(f"tree again {same}")
                        if not same:
                            failed.append(f"{label} K={K} {side} beta={beta:g}"
                                          ": split bits differ between launches")
                    continue
                if splits == 1:
                    same = all(torch.equal(a, b) for a, b in zip(outs, ref))
                    sames.append(f"{name} {same}")
                    if not same:
                        failed.append(f"{label} K={K} {side} beta={beta:g} "
                                      f"{name}: bits differ")
                    continue
                dist = max(float(torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b))
                           for a, b in zip(ref, outs))
                sames.append(f"{name} in norm {dist:.3e}")
                if dist > SPLIT_BOUND:
                    failed.append(f"{label} K={K} {side} beta={beta:g}: split "
                                  f"{dist:.3e} from {name}")
            tag = f"{label} B={B} N={N} G={G} K={K} {side} beta={beta:g}"
            cut = f" split {splits} x {per_split}" if splits > 1 else ""
            print(f"[tune-check] {tag}{cut}: max_rel_diff vs plain "
                  f"{', '.join(rels)}; bits equal to tree's: "
                  f"{', '.join(sames) or '-'}"
                  + (f"; max_rel_diff vs f64 {', '.join(notes)}" if notes
                     else ""), flush=True)
            b = 1 if splits > 1 else B
            grid = [tiling(K, b, M, sxm, sxc, beta, f) for f in range(4)]
            cases.append((tag, calls,
                          grid_text(grid, B, M, sms, splits, per_split)))
    return cases


def path_inputs():
    """The KL path's own X: the normalized counts (2700 cells x 2000 HVGs)
    and the TPM (2700 x 10000) of bench.py's counts, as float32 arrays."""
    from bench import make_counts
    from cnmf_tpu_torch.pipeline import stages

    prep = stages.prepare_arrays(make_counts(2700, 10000, seed=7),
                                 num_highvar_genes=2000)
    return {"norm": np.ascontiguousarray(prep.norm, dtype=np.float32),
            "tpm": np.ascontiguousarray(prep.tpm, dtype=np.float32)}


def xlogwh_cases(sos, sms, failed):
    """The KL divergence term: (label, {build: call}, grid) per case of
    XLW_CASES, every build checked against the float64 plain version and
    the tree's result by value; the tree's split cases against themselves
    by bits."""
    import torch

    from chip_smoke import bound, kernel_work
    from cnmf_tpu_torch.ops import mu_kernels as mk

    whole = {name: raising(bind(so, "mu_kl_x_log_wh", mk._ARGS),
                           "mu_kl_x_log_wh") for name, so in sos.items()}
    split = raising(bind(sos["tree"], "mu_kl_x_log_wh_split",
                         mk._SPLIT_ARGS), "mu_kl_x_log_wh_split")
    tiling = bind(sos["tree"], "mu_kl_x_log_wh_tiling", mk._XLW_TILING_ARGS)
    print("[tune-occupancy] tree kl_x_log_wh_kernel (one row, split build): "
          "blocks an SM " + " ".join(
              f"K={K}:{tiling(K, 1, 1, 1, 3)}" for K in CD_BUCKETS + (72,)),
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    path = path_inputs()
    cases = []
    for label, B, N, G, K, pad, view, source in XLW_CASES:
        if source == "path":
            X = path["tpm"].T if view else path["norm"]
        else:
            X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.3)).astype(
                np.float32)
        assert X.shape == (N, G), (label, X.shape)
        bound_ms, _ = bound(*kernel_work("kl_x_log_wh", X, B, N, G, K))
        avg = np.sqrt(X.mean() / K)
        W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
        Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
        W[:, :, K - pad:] = 0.0
        Ht[:, :, K - pad:] = 0.0
        X = (torch.as_tensor(np.ascontiguousarray(X.T), device=dev).T if view
             else torch.as_tensor(X, device=dev))
        W, Ht = (torch.as_tensor(a, device=dev) for a in (W, Ht))
        C, sxm, sxc = mk._x_strides(X, False)
        one_row = [tiling(K, 1, 1, 1, f) for f in (0, 3, 4)]
        splits, per_split = mk.split_plan(B, N, C, sms, *one_row)
        exact = mk.kl_x_log_wh_plain(X.double(), W.double(), Ht.double())
        tag = (f"{label}{', path X' if source == 'path' else ''} B={B} N={N} "
               f"G={G} K={K}")
        calls, errs, diffs = {}, [], []
        for name, fn in whole.items():
            args = (X, N, C, sxm, sxc, Ht, W, B, K)
            # a partials row for every row of W (and slice), so no build's
            # tiling needs to be read: rows its grid does not write stay 0
            if name == "tree" and splits > 1:
                part = torch.zeros((splits * N, B), dtype=torch.float64,
                                   device=dev)
                call = bound_call(split, *args, splits, per_split, part,
                                  stream)
            else:
                part = torch.zeros((N, B), dtype=torch.float64, device=dev)
                call = bound_call(fn, *args, part, stream)
            call()
            torch.cuda.synchronize()
            out = part.sum(dim=0).float()
            calls[name] = call
            err = float(((out.double() - exact).abs() / exact.abs()).max())
            errs.append(f"{name} {err:.3e}")
            if err > XLW_EXACT:
                failed.append(f"{tag} {name}: {err:.3e} from f64")
            if name == "tree":
                ref = out
                if splits > 1:
                    bits = part.clone()
                    call()
                    torch.cuda.synchronize()
                    same = bool(torch.equal(part, bits))
                    diffs.append(f"tree again same bits {same}")
                    if not same:
                        failed.append(f"{tag}: split bits differ between "
                                      "launches")
                continue
            d = float(((out - ref).abs() / ref.abs()).max())
            diffs.append(f"{name} {d:.3e}")
            if d > XLW_BUILDS:
                failed.append(f"{tag} {name}: {d:.3e} from the tree's")
        cut = f" split {splits} x {per_split}" if splits > 1 else ""
        print(f"[tune-check] {tag}{cut}: max rel diff vs f64 "
              f"{', '.join(errs)}; vs tree's {', '.join(diffs) or '-'}",
              flush=True)
        b = 1 if splits > 1 else B
        grid = [tiling(K, b, N, sxc, f) for f in range(4)]
        cases.append((tag, calls,
                      grid_text(grid, B, N, sms, splits, per_split)
                      + f"; bound {bound_ms:.4f} ms"))
    return cases


def grid_text(tiling, B, M, sms, splits=1, per_split=None):
    rows, rb, threads, per_sm = tiling
    blocks = -(-M // rows) * -(-B // rb) * splits
    waves = f"{blocks / (per_sm * sms):.2f}" if per_sm else "n/a"
    cut = f"split {splits} x {per_split} entries, " if splits > 1 else ""
    return (f"{cut}{rows} rows x {rb} restarts, {threads} threads, {blocks} "
            f"blocks, {per_sm} per SM, waves {waves}, {blocks / sms:.2f} "
            "blocks an SM")


def main():
    import torch

    from chip_smoke import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="cd")
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=CSRC_DIR",
                    help="csrc directory of another version of the kernel")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tune_cd: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    source, family, families = KERNELS[args.kernel]
    here = os.path.dirname(os.path.abspath(__file__))
    sources = {"tree": os.path.join(here, "cnmf_tpu_torch", "csrc", source)}
    for spec in args.against:
        name, _, path = spec.partition("=")
        sources[name] = os.path.join(path, source)
    out_dir = os.path.join(here, "cnmf_tpu_torch", "_build", "tune")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(sources, out_dir, families)
    print(f"[tune-build] {len(built)} builds of {source} in parallel in "
          f"{time.perf_counter() - t0:.2f} s; card: {card}", flush=True)
    for name, (so, lines) in built.items():
        for ln in lines:
            print(f"[tune-ptxas] {name}: {ln}", flush=True)
    sos = {name: so for name, (so, _) in built.items()}
    for K in (8, 16):
        for half, (n, ffma, rest) in sorted(
                loop_mix(sos["tree"], family, K).items()):
            print(f"[tune-sass] tree {family} K={K} {half}: main loop {n} "
                  f"instructions, FFMA {ffma} ({ffma / n:.0%}); then {rest}",
                  flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = []
    cases = {"cd": cd_cases, "kl": kl_cases, "beta": beta_cases,
             "xlogwh": xlogwh_cases}[args.kernel](sos, sms, failed)

    times = collections.defaultdict(list)
    names = list(sos)
    for rnd in range(args.rounds):
        order = names if rnd % 2 == 0 else names[::-1]
        for tag, calls, _ in cases:
            for name in order:
                try:
                    calls[name]()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(LAUNCHES):
                        calls[name]()
                    end.record()
                    end.synchronize()
                except Exception:
                    print(f"[tune-fail] round {rnd}, {tag}, {name}: the "
                          "launches failed", flush=True)
                    raise
                times[(name, tag)].append(start.elapsed_time(end) / LAUNCHES)
    for tag, _, grid in cases:
        ms = {name: float(np.median(times[(name, tag)])) for name in names}
        others = "".join(f" | {name} {ms[name]:.4f} ({ms[name] / ms['tree']:.2f}x)"
                         for name in names[1:])
        print(f"[tune] {tag}: tree {ms['tree']:.4f} ms ({grid}){others}; "
              f"median of {args.rounds} rounds x {LAUNCHES} launches",
              flush=True)
    for msg in failed:
        print(f"[tune-fail] {msg}", flush=True)
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
