"""Solver dispatch: sklearn-style NMF kwargs → the batched CD or MU solver.

A subset of ``cnmf_tpu.pipeline.solvers``. The pipeline persists one YAML
kwargs dict per run (same keys as the reference's sklearn kwargs,
cnmf.py:618-631) and every stage rebuilds its solver from it: ``solver="cd"``
(frobenius) or ``solver="mu"`` (any beta loss). Where a solve runs follows
its tensors: CUDA tensors go through the hand-written kernels of
``ops.cd_kernels`` and ``ops.mu_kernels``, CPU tensors through their plain
PyTorch versions. That replaces the JAX package's ``cd_pallas_eligible`` /
``mu_pallas_eligible`` gates. On CUDA every beta runs: MU at beta=2 runs
plain matmuls, at beta=1 the KL kernels, at any other beta (0 is
Itakura-Saito) the general-beta kernels.

On the card a factorize solve takes the device ladder
(``solve_nmf_batch_ladder``) unless ``CNMF_TPU_DEVICE_LADDER=0``
(``device_ladder_enabled``), from random inits drawn there from each
restart's threefry key unless ``CNMF_TPU_DEVICE_INIT=0``
(``device_init_enabled``, ``draw_restart_factors``; the JAX package's
names ``solve_nmf_batch_ladder_seeded`` and the mesh twins
``solve_nmf_sharded_device`` / ``solve_nmf_batch_sharded_seeded`` draw,
then call the solver the inits are given to).

On a mesh (``parallel.mesh``): ``solve_nmf_batch_sharded`` splits the
restarts over the restart axis (each restart group on its own host thread,
on a replica of X) and X's rows over the cell axis (the cell-sharded loops
of ``ops.nmf``); ``solve_nmf_ladder_sharded`` is its restart-axis twin on
the device ladder. The refits take a row-sharded X or TPM
(``parallel.mesh.Shards``), and ``shard_products_rows`` row-shards the
products-given solve of the over-limit atlas consensus.

The knobs of the one-program consensus and the compact TPM resolve here
too (``fused_consensus_enabled``, ``device_tpm_enabled``,
``prefetch_tpm_enabled``, ``device_norm_enabled``; CNMF_TPU_CSR_UPLOAD's
is ``ops.device_tpm.csr_upload_enabled``, where the JAX package has it),
and those of the stage hand-off (``device_spectra_enabled``,
``async_writes_enabled``, ``phases_enabled``), of the opt-in schedules
(``staged_enabled``, ``grid_enabled``, ``compact_enabled``;
``solve_nmf_staged``, ``solve_nmf_grid``,
``solve_nmf_batch(compact=True)``), of the MU precision ladder
(``mu_precision_ladder_enabled``: ``solve_nmf_batch``'s MU solves with H
updated run ``ops.nmf.nmf_mu_precision_ladder``, a TF32 coarse phase on the
card then an f32 finish) and of the autowarm (``autowarm_enabled``).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cnmf_tpu_torch.native import densify_csr
from cnmf_tpu_torch.ops import mu_kernels
from cnmf_tpu_torch.ops.cd_kernels import numpy_dtype, pad_bucket, torch_dtype
from cnmf_tpu_torch.ops.init import nnls_w_init, random_init_batch_device
from cnmf_tpu_torch.ops.nmf import (
    _ladder,
    fixed_factor_gram,
    fixed_factor_product_transposed,
    nmf_cd_device_ladder,
    nmf_cd_grid,
    nmf_cd_staged,
    nmf_coordinate_descent,
    nmf_coordinate_descent_compacted,
    nmf_mu_device_ladder,
    nmf_mu_precision_ladder,
    nmf_multiplicative_update,
    nnls_cd_fixed_spectra,
    nnls_cd_from_products,
)
from cnmf_tpu_torch.parallel.collectives import gather_shards, sum_shards
from cnmf_tpu_torch.parallel import mesh as parallel_mesh
from cnmf_tpu_torch.parallel.mesh import (
    Shards,
    build_mesh,
    pad_to_multiple,
    shard_factorize_inputs,
    shard_like,
    split_rows,
)

BETA_LOSS = {"frobenius": 2.0, "kullback-leibler": 1.0, "itakura-saito": 0.0}


def beta_loss_to_float(beta_loss) -> float:
    if isinstance(beta_loss, str):
        return BETA_LOSS[beta_loss]
    return float(beta_loss)


def compute_regularization(
    alpha_W: float, alpha_H, l1_ratio: float, shape
) -> Tuple[float, float, float, float]:
    """sklearn _compute_regularization scaling: W-regs scale with n_features,
    H-regs with n_samples."""
    n_samples, n_features = shape
    if alpha_H == "same" or alpha_H is None:
        alpha_H = alpha_W
    l1_reg_W = n_features * alpha_W * l1_ratio
    l1_reg_H = n_samples * alpha_H * l1_ratio
    l2_reg_W = n_features * alpha_W * (1.0 - l1_ratio)
    l2_reg_H = n_samples * alpha_H * (1.0 - l1_ratio)
    return float(l1_reg_W), float(l1_reg_H), float(l2_reg_W), float(l2_reg_H)


def _regularization(nmf_kwargs: dict, shape):
    return compute_regularization(
        float(nmf_kwargs.get("alpha_W", 0.0)),
        nmf_kwargs.get("alpha_H", "same"),
        float(nmf_kwargs.get("l1_ratio", 0.0)),
        shape,
    )


def _is_mu(nmf_kwargs: dict) -> bool:
    """True for the MU solver; the CD solver takes frobenius loss only."""
    if nmf_kwargs.get("solver", "cd") != "cd":
        return True
    if beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius")) != 2.0:
        raise ValueError("CD solver supports frobenius loss only")
    return False


def solve_nmf_batch(
    X: torch.Tensor,
    W0: torch.Tensor,
    Ht0: torch.Tensor,
    nmf_kwargs: dict,
    update_H: bool = True,
    compact: bool = False,
    info: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the batched solver described by sklearn-style kwargs.

    X: (N, G); W0: (B, N, K); Ht0: (B, G, K), all on one device. Returns
    (W, Ht, n_iter). ``compact``: drop finished restarts from the batch
    between segments (CD with update_H only,
    ``ops.nmf.nmf_coordinate_descent_compacted``); ``info``, a dict, then
    gains "executed", its restart-sweeps. With CNMF_TPU_MU_PRECISION_LADDER
    on, a MU solve with H updated runs ``ops.nmf.nmf_mu_precision_ladder``
    and ``info`` gains "phase_n_iter", each phase's n_iter."""
    tol = float(nmf_kwargs.get("tol", 1e-4))
    max_iter = int(nmf_kwargs.get("max_iter", 200))
    l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H = _regularization(nmf_kwargs, X.shape)
    regs = dict(l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H, l2_reg_W=l2_reg_W,
                l2_reg_H=l2_reg_H)
    if _is_mu(nmf_kwargs):
        # any beta, on either device (ops.nmf picks the kernels per beta);
        # CNMF_TPU_MU_PRECISION_LADDER: a coarse TF32 phase, then the finish
        # (cnmf_tpu/pipeline/solvers.py:201-214)
        beta = beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius"))
        if update_H and mu_precision_ladder_enabled():
            return nmf_mu_precision_ladder(
                X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter, info=info,
                **regs)
        return nmf_multiplicative_update(
            X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter,
            update_H=update_H, **regs,
        )
    if not update_H:
        # fixed-spectra refit → products-distilled half-sweep loop
        W, n_iter = nnls_cd_fixed_spectra(
            X, Ht0, W0, tol=tol, max_iter=max_iter,
            l1_reg=l1_reg_W, l2_reg=l2_reg_W,
        )
        return W, Ht0, n_iter
    if compact:
        return nmf_coordinate_descent_compacted(
            X, W0, Ht0, tol=tol, max_iter=max_iter, info=info, **regs)
    return nmf_coordinate_descent(
        X, W0, Ht0, tol=tol, max_iter=max_iter, update_H=True, **regs,
    )


def mu_precision_ladder_enabled() -> bool:
    """The CNMF_TPU_MU_PRECISION_LADDER knob (cnmf_tpu/pipeline/
    solvers.py:221-227): '1' runs ``solve_nmf_batch``'s MU solves with H
    updated as the two-phase precision ladder; default '0'. The factors
    then agree with the one-phase solve to the finish's stop rule, not bit
    for bit. The device ladder (the card's default factorize) does not take
    it, as in the JAX package."""
    return os.environ.get("CNMF_TPU_MU_PRECISION_LADDER", "0") == "1"


def compact_enabled() -> bool:
    """The CNMF_TPU_COMPACT knob (cnmf_tpu/pipeline/cnmf.py:2138, 2180):
    '1' solves each K's CD restarts with between-segment compaction
    (``solve_nmf_batch(compact=True)``) instead of the device ladder or the
    plain batched solver, on one device; default '0'."""
    return os.environ.get("CNMF_TPU_COMPACT", "0") == "1"


def grid_enabled() -> bool:
    """The CNMF_TPU_GRID knob (cnmf_tpu/pipeline/cnmf.py:1838): '1' solves
    every restart of a pad-K bucket as one tail-compacted schedule
    (``solve_nmf_grid``); default '0'."""
    return os.environ.get("CNMF_TPU_GRID", "0") == "1"


def staged_enabled() -> bool:
    """The CNMF_TPU_STAGED knob (cnmf_tpu/pipeline/cnmf.py:1777): '1' runs
    the per-K solves for 250 sweeps, then one merged
    ladder continuation of every K's survivors (``solve_nmf_staged``);
    default '0'. It takes precedence over CNMF_TPU_GRID."""
    return os.environ.get("CNMF_TPU_STAGED", "0") == "1"


def autowarm_enabled() -> bool:
    """The CNMF_TPU_AUTOWARM knob (cnmf_tpu/pipeline/cnmf.py:2338): '1'
    (default) starts the kernel library's build on a background thread when
    factorize or k-selection starts on a CUDA device; '0' leaves it to the
    first launch."""
    return os.environ.get("CNMF_TPU_AUTOWARM", "1") == "1"


def _cd_only(nmf_kwargs: dict, name: str, shape):
    """The regularization keywords of a CD-only scheduler on X of
    ``shape``."""
    if _is_mu(nmf_kwargs):
        raise ValueError(f"{name} is CD/frobenius only")
    return dict(zip(("l1_reg_W", "l1_reg_H", "l2_reg_W", "l2_reg_H"),
                    _regularization(nmf_kwargs, shape)))


def solve_nmf_grid(X, W0, Ht0, nmf_kwargs: dict, seg_len: int = 125,
                   min_bucket: int = 32):
    """Tail-compacted CD over a merged restart batch, every restart sharing
    one padded component count across K values
    (cnmf_tpu/pipeline/solvers.py:230; ``ops.nmf.nmf_cd_grid``). Returns
    (spectra (B, pad_k, G), n_iter (B,), executed (B,)) host arrays.
    CD/frobenius only."""
    regs = _cd_only(nmf_kwargs, "solve_nmf_grid", X.shape)
    return nmf_cd_grid(
        X, W0, Ht0, tol=float(nmf_kwargs.get("tol", 1e-4)),
        max_iter=int(nmf_kwargs.get("max_iter", 200)), seg_len=seg_len,
        min_bucket=min_bucket, **regs)


def solve_nmf_staged(X, inits, nmf_kwargs: dict, s0: int = 250,
                     seg_len: int = 125, min_bucket: int = 32):
    """Two-phase tail-compacted CD over per-K init batches
    (cnmf_tpu/pipeline/solvers.py:665; ``ops.nmf.nmf_cd_staged``): per-K
    segments of ``s0`` sweeps, then one merged
    ladder continuation of the stragglers. Returns per K, in input order,
    (spectra (B_k, pad_k, G), n_iter, executed) host arrays. CD/frobenius
    only."""
    regs = _cd_only(nmf_kwargs, "solve_nmf_staged", X.shape)
    return nmf_cd_staged(
        X, inits, tol=float(nmf_kwargs.get("tol", 1e-4)),
        max_iter=int(nmf_kwargs.get("max_iter", 200)),
        s0=s0, seg_len=seg_len,
        min_bucket=min_bucket, **regs)


def device_ladder_enabled(X: torch.Tensor, ladder: Optional[bool] = None) -> bool:
    """Whether a factorize solve on X's device takes the device ladder:
    ``ladder`` as given, else the CNMF_TPU_DEVICE_LADDER knob ('1' on, '0'
    off), else on for CUDA tensors and off on the CPU, where the plain
    batched solver stays (cnmf_tpu/pipeline/solvers.py:531)."""
    if ladder is not None:
        return bool(ladder)
    env = os.environ.get("CNMF_TPU_DEVICE_LADDER", "")
    return env == "1" or (env != "0" and X.device.type == "cuda")


def _accelerator_knob(name: str, device) -> bool:
    """A knob of the JAX package's accelerator defaults: '0' off, 'force'
    on for any device, '1' (the default) on where ``device`` is a CUDA card
    (the JAX package: the TPU backend). ``device`` None: the port's default
    device, the card where one is visible."""
    env = os.environ.get(name, "1")
    if env == "0":
        return False
    if env == "force":
        return True
    if device is None:
        return env == "1" and torch.cuda.is_available()
    return env == "1" and torch.device(device).type == "cuda"


def device_init_enabled(device=None) -> bool:
    """The CNMF_TPU_DEVICE_INIT knob (cnmf_tpu/pipeline/solvers.py:256):
    whether factorize draws the random restart inits on ``device`` from
    threefry keys (``ops.init.random_init_batch_device``). '0' keeps the
    sklearn-exact host ``RandomState`` draw, 'force' draws on any device
    (the CPU tests), '1' (default) draws on a CUDA card only: the CPU keeps
    the host draw, as the JAX package does off its TPU."""
    return _accelerator_knob("CNMF_TPU_DEVICE_INIT", device)


def device_kmeanspp_enabled(device=None) -> bool:
    """The CNMF_TPU_DEVICE_KMEANSPP knob (cnmf_tpu/pipeline/solvers.py:270):
    whether consensus seeds its KMeans with the threefry-keyed kmeans++ on
    ``device`` (``ops.kmeans.seed_kmeanspp_batch``) instead of the host's
    numpy stream. '0' off, 'force' on for any device, '1' (default) on a
    CUDA card only."""
    return _accelerator_knob("CNMF_TPU_DEVICE_KMEANSPP", device)


def fused_consensus_enabled() -> bool:
    """The CNMF_TPU_FUSED_CONSENSUS knob (cnmf_tpu/pipeline/cnmf.py:
    3245-3316): '1' (the default, on every device) runs consensus with the
    TPM resident as one chain on the device (``ops.consensus_fused``: the
    whole of it where ``device_kmeanspp_enabled``, after a host kmeans++
    seeding elsewhere); any other value keeps the step-by-step path."""
    return os.environ.get("CNMF_TPU_FUSED_CONSENSUS", "1") == "1"


def device_tpm_enabled() -> bool:
    """The CNMF_TPU_DEVICE_TPM knob: '1' (default, every device) keeps
    prepare's compact integer image of the counts (``ops.device_tpm``) for
    the device TPM; '0' keeps the float upload of the TPM read back."""
    return os.environ.get("CNMF_TPU_DEVICE_TPM", "1") == "1"


def prefetch_tpm_enabled() -> bool:
    """The CNMF_TPU_PREFETCH_TPM knob: '1' (default) starts the consensus
    TPM's upload on a side stream when factorize starts; '0' leaves it to
    consensus."""
    return os.environ.get("CNMF_TPU_PREFETCH_TPM", "1") == "1"


def device_norm_enabled(device=None) -> bool:
    """The CNMF_TPU_DEVICE_NORM knob: whether factorize derives its input
    on ``device`` from the compact integer counts (``ops.device_tpm.
    norm_from_counts``) instead of uploading the float matrix: '1' on any
    device, '0' off, unset on a CUDA card only (the JAX package: its TPU)."""
    env = os.environ.get("CNMF_TPU_DEVICE_NORM", "")
    if env in ("0", "1"):
        return env == "1"
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def device_spectra_enabled(device=None) -> bool:
    """The CNMF_TPU_DEVICE_SPECTRA knob (cnmf_tpu/pipeline/solvers.py:
    288-307): whether factorize leaves its packed true-K spectra on
    ``device`` as the twin that a same-process consensus and k-selection
    take instead of uploading the merged spectra again (normalized there:
    one reduction reordered, about 1e-7 relative in float32), and whether
    ``CNMF_TPU_ASYNC_WRITES=1`` defers factorize's drain to the background
    writer. '0' off, 'force' on for any device, '1' (default) on a CUDA
    card only."""
    return _accelerator_knob("CNMF_TPU_DEVICE_SPECTRA", device)


def async_writes_enabled() -> bool:
    """The CNMF_TPU_ASYNC_WRITES knob: '1' puts the stages' artifact writes
    on one background writer thread (``cNMF.flush_writes`` joins them); any
    other value, the library default '0', writes them before each stage
    returns. The CLI sets it to '1' for its command."""
    return os.environ.get("CNMF_TPU_ASYNC_WRITES", "0") == "1"


def phases_enabled() -> bool:
    """The CNMF_TPU_PHASES knob: '1' splits factorize's wall into upload,
    init, dispatch, solve wait, result fetch and write
    (``cNMF._factorize_phases``), at the cost of one stream barrier before
    each timed fetch."""
    return os.environ.get("CNMF_TPU_PHASES", "0") == "1"


def ladder_rungs(X: torch.Tensor, B: int, K: int, nmf_kwargs: dict,
                 min_bucket: int = 16) -> tuple:
    """The batch sizes a factorize solve of B restarts at bucket K shrinks
    through: ``ops.nmf._ladder``'s, less, for MU on CUDA, every rung whose
    arithmetic would differ from the first rung's. At beta 2 that is every
    later rung: its products are cuBLAS GEMMs over the whole batch
    (``cd_kernels._shared_x_dot``), whose split of the contraction may follow
    the batch's width. At any other beta it is every rung whose kernels
    would split their contraction otherwise than the first rung's
    (``mu_kernels.split_plan`` splits a small grid).

    The ladder keeps the plain solver's n_iter and bits where every other
    launch of a step gives each restart the same bits at every rung's size
    and place in the batch: the kernels, ``cd_kernels._gram``'s ``bmm``, the
    kernels' partial sums, and the factor sums and divergences that
    ``mu_kernels.restart_sums`` and whole chunks give a fixed order.
    ``chip_smoke.py``'s ``[batch]`` line checks that at every bucket 8..64
    with the main path's X (2700 × 2000) on an H100; other shapes and cards
    are not checked."""
    ladder = _ladder(int(B), min_bucket)
    if not _is_mu(nmf_kwargs) or X.device.type != "cuda":
        return tuple(ladder)
    beta = beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius"))
    if beta == 2:
        return tuple(ladder[:1])
    plan = mu_kernels.launch_splits(X, ladder[0], K, beta)
    return tuple(ladder[:1] + [s for s in ladder[1:] if
                               mu_kernels.launch_splits(X, s, K, beta) == plan])


def solve_nmf_batch_ladder(X, W0, Ht0, nmf_kwargs: dict, min_bucket: int = 16):
    """The factorize solve on a batch that shrinks as restarts finish
    (``ops.nmf.nmf_cd_device_ladder`` / ``nmf_mu_device_ladder``) through
    ``ladder_rungs``, CD or MU by the sklearn-style kwargs
    (cnmf_tpu/pipeline/solvers.py:540); update_H=True only. Returns
    (spectra (B, K, G), n_iter (B,), (ladder sizes, stage_sweeps))."""
    tol = float(nmf_kwargs.get("tol", 1e-4))
    max_iter = int(nmf_kwargs.get("max_iter", 200))
    l1_reg_W, l1_reg_H, l2_reg_W, l2_reg_H = _regularization(nmf_kwargs, X.shape)
    regs = dict(l1_reg_W=l1_reg_W, l1_reg_H=l1_reg_H, l2_reg_W=l2_reg_W,
                l2_reg_H=l2_reg_H)
    ladder = ladder_rungs(X, W0.shape[0], W0.shape[2], nmf_kwargs, min_bucket)
    if not _is_mu(nmf_kwargs):
        spec, n_iter, sweeps = nmf_cd_device_ladder(
            X, W0, Ht0, tol=tol, max_iter=max_iter, ladder=ladder, **regs)
        return spec, n_iter, (ladder, sweeps)
    beta = beta_loss_to_float(nmf_kwargs.get("beta_loss", "frobenius"))
    spec, n_iter, sweeps = nmf_mu_device_ladder(
        X, W0, Ht0, beta=beta, tol=tol, max_iter=max_iter, ladder=ladder,
        **regs)
    return spec, n_iter, (ladder, sweeps)


def draw_restart_factors(seeds, x_mean: float, k: int, pad_k: int, n: int,
                         g: int, device, dtype,
                         timings: Optional[dict] = None):
    """``ops.init.random_init_batch_device`` on ``device`` at ``dtype``,
    timed: ``timings["init"]`` gains the draw's seconds (synchronized on a
    card)."""
    t0 = time.perf_counter()
    W0, Ht0 = random_init_batch_device(x_mean, n, g, k, seeds, pad_k=pad_k,
                                       dtype=numpy_dtype(dtype),
                                       device=device)
    if timings is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        timings["init"] = timings.get("init", 0.0) + time.perf_counter() - t0
    return W0, Ht0


def solve_nmf_batch_ladder_seeded(X, seeds, x_mean: float, k: int,
                                  pad_k: int, nmf_kwargs: dict,
                                  min_bucket: int = 16,
                                  timings: Optional[dict] = None):
    """The single-device factorize with its inits drawn on X's device
    (cnmf_tpu/pipeline/solvers.py:591-663): only the seeds leave the host;
    each restart's factors come from its own threefry key, then
    ``solve_nmf_batch_ladder`` runs them. The same return as that function.
    ``timings["init"]`` gains the draw's seconds."""
    n, g = X.shape
    W0, Ht0 = draw_restart_factors(seeds, x_mean, k, pad_k, n, g, X.device,
                                   X.dtype, timings)
    return solve_nmf_batch_ladder(X, W0, Ht0, nmf_kwargs, min_bucket)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

def _on_device(dev, fn, *args):
    """fn(*args) with ``dev`` as the thread's current CUDA device."""
    if torch.device(dev).type == "cuda":
        with torch.cuda.device(dev):
            return fn(*args)
    return fn(*args)


def _per_group(mesh, fn, groups):
    """fn(*group) for each restart group, each on its own host thread with
    its first device current (one group: this thread), in group order. A
    group's failure raises here."""
    if len(groups) == 1:
        return [_on_device(mesh.devices[0][0], fn, *groups[0])]
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        futures = [pool.submit(_on_device, row[0], fn, *group)
                   for row, group in zip(mesh.devices, groups)]
        return [f.result() for f in futures]


def _restart_padded(mesh, W0, Ht0):
    """W0, Ht0 with the restarts padded to the restart axis' multiple
    (copies of restart 0), where they lie (host arrays, or tensors left on
    their device), and the true restart count."""
    if isinstance(W0, torch.Tensor):
        first = [0] * ((-W0.shape[0]) % mesh.shape["restart"])
        return (torch.cat([W0, W0[first]]), torch.cat([Ht0, Ht0[first]]),
                W0.shape[0])
    W0p, true_b = pad_to_multiple(np.asarray(W0), mesh.shape["restart"])
    Ht0p, _ = pad_to_multiple(np.asarray(Ht0), mesh.shape["restart"])
    return W0p, Ht0p, true_b


def solve_nmf_batch_sharded(mesh, X, W0, Ht0, nmf_kwargs: dict,
                            update_H: bool = True, mu_chunk: int = 8,
                            force_shard_map: bool = False):
    """Batched solve over a (restart, cell) mesh (cnmf_tpu/pipeline/
    solvers.py:694-786); returns (W, Ht, n_iter) sliced back to the true
    restart count, gathered in restart order on the mesh's first device.

    The restart batch pads to the restart-shard multiple (repeating restart
    0; padded results are discarded). Each restart group solves its share on
    its own host thread, so one group's block sync never holds another: on a
    replica of X (``cell`` 1; the solver is restart-separable, so each
    restart's factors are those of a solve alone), or with X's rows and W's
    split over the group's devices (the cell-sharded loops of ``ops.nmf``:
    W's padded rows are zero and stay zero). The regularization scales with
    X's real row count. X: a host array or a tensor (placed once per X,
    ``Mesh.place_data``). ``mu_chunk`` and ``force_shard_map`` are accepted
    for the JAX package's API: every MU solve here runs the port's kernels
    per shard."""
    W0p, Ht0p, true_b = _restart_padded(mesh, W0, Ht0)
    Xs, W0s, Ht0s = shard_factorize_inputs(mesh, X, W0p, Ht0p)
    out = _per_group(mesh, lambda x, w, h: solve_nmf_batch(
        x, w, h, nmf_kwargs, update_H=update_H), list(zip(Xs, W0s, Ht0s)))
    dev = mesh.devices[0][0]
    W = torch.cat([(gather_shards(w) if isinstance(w, Shards) else w).to(dev)
                   for w, _, _ in out])
    Ht = torch.cat([h.to(dev) for _, h, _ in out])
    n_iter = torch.cat([n.to(dev) for _, _, n in out])
    return W[:true_b], Ht[:true_b], n_iter[:true_b]


def solve_nmf_batch_sharded_seeded(mesh, X, seeds, x_mean: float, k: int,
                                   pad_k: int, nmf_kwargs: dict,
                                   mu_chunk: int = 8,
                                   n_cells: Optional[int] = None,
                                   timings: Optional[dict] = None):
    """``solve_nmf_batch_sharded`` from inits drawn on the mesh's first
    device (cnmf_tpu/pipeline/solvers.py:405-530): W at the real cell
    count, its padded cells' rows zero as the JAX package's row mask makes
    them (a draw's real rows do not depend on the row count it is drawn
    at). The regularization scales with the real ``n_cells`` (default X's
    rows; a pre-padded X is cut to it). ``timings["init"]`` gains the
    draw's seconds. ``mu_chunk`` is accepted for the JAX package's API."""
    if n_cells is not None and n_cells < X.shape[0]:
        X = X[:n_cells]
    W0, Ht0 = draw_restart_factors(seeds, x_mean, k, pad_k, *X.shape,
                                   mesh.devices[0][0], X.dtype, timings)
    return solve_nmf_batch_sharded(mesh, X, W0, Ht0, nmf_kwargs)


def solve_nmf_sharded_device(mesh, X, seeds, x_mean: float, k: int,
                             pad_k: int, nmf_kwargs: dict,
                             min_bucket: int = 16, mu_chunk: int = 8,
                             timings: Optional[dict] = None):
    """``solve_nmf_ladder_sharded`` from inits drawn on the mesh's first
    device (cnmf_tpu/pipeline/solvers.py:309-403). A restart's draw is
    keyed by its own seed, so the result has one device's bits.
    ``timings["init"]`` gains the draw's seconds. ``mu_chunk`` is accepted
    for the JAX package's API."""
    W0, Ht0 = draw_restart_factors(seeds, x_mean, k, pad_k, *X.shape,
                                   mesh.devices[0][0], X.dtype, timings)
    return solve_nmf_ladder_sharded(mesh, X, W0, Ht0, nmf_kwargs, min_bucket)


def solve_nmf_ladder_sharded(mesh, X, W0, Ht0, nmf_kwargs: dict,
                             min_bucket: int = 16):
    """The restart-axis factorize on the device ladder, each restart group
    on its own host thread with a replica of X: the role of the JAX
    package's ``solve_nmf_sharded_device`` (cnmf_tpu/pipeline/solvers.py:
    309-403), with the inits given (``solve_nmf_sharded_device`` draws them
    on the device).
    Returns (spectra (B, K, G), n_iter (B,), (ladder sizes, sweeps at each
    rung summed over groups)) on the mesh's first device, like
    ``solve_nmf_batch_ladder``. Restart-axis meshes only."""
    if mesh.shape["cell"] != 1:
        raise ValueError("solve_nmf_ladder_sharded is restart-axis only")
    W0p, Ht0p, true_b = _restart_padded(mesh, W0, Ht0)
    Xs, W0s, Ht0s = shard_factorize_inputs(mesh, X, W0p, Ht0p)
    out = _per_group(mesh, lambda x, w, h: solve_nmf_batch_ladder(
        x, w, h, nmf_kwargs, min_bucket), list(zip(Xs, W0s, Ht0s)))
    dev = mesh.devices[0][0]
    spec = torch.cat([s.to(dev) for s, _, _ in out])
    n_iter = torch.cat([n.to(dev) for _, n, _ in out])
    ladder = out[0][2][0]
    sweeps = [sum(o[2][1][i] for o in out) for i in range(len(ladder))]
    return spec[:true_b], n_iter[:true_b], (ladder, sweeps)


# The restart axis pays where each restart group's loop is device-bound.
# Every group's host thread launches every kernel of its own loop, under
# one interpreter lock, so n groups cost about n times one device's host
# time a sweep (1.1-1.7 ms for each group), while each card's device work
# a sweep falls to 1/n: about 1.5e-13 s per multiply-add of B·N·G·K. The
# restart axis is faster where B·N·G·K ≥ n · RESTART_AXIS_WORK. Measured
# with the CD factorize on four H100 80GB HBM3 at 700 W
# (chip_mesh_cards.py): at 2,700 × 2,000, K ≤ 16, 100 restarts (8.6e9) one
# card took 4.8-7.3 s and the restart axis 9.6-9.8 s on 2 cards, 31-32 s on
# 4; at 100,000 × 2,000, K=12 (bucket 16), 30 restarts (9.6e10) one card
# took 15.2 s, 2 cards 10.6 s, 4 cards 9.2 s.
RESTART_AXIS_WORK = 1e10


def restart_axis_pays(mesh, shape, n_restarts: int, k: int) -> bool:
    """Whether ``cNMF.factorize`` lays ``n_restarts`` restarts of rank k on
    X of ``shape`` (cells, genes) over ``mesh``: a mesh with a cell axis
    always (it shards X, which may not fit one device); a restart-only mesh
    where B·N·G·K (K its bucket of 8) reaches RESTART_AXIS_WORK for each
    restart group, else one device is faster."""
    if mesh.shape["cell"] > 1:
        return True
    n, g = shape
    work = float(n_restarts) * n * g * pad_bucket(k)
    return work >= mesh.shape["restart"] * RESTART_AXIS_WORK


def _match_factor_shardings(X, W0, Ht0):
    """W0 / Ht0 laid out on X's shards (cnmf_tpu/pipeline/solvers.py:
    788-803): W's rows follow X's rows and Ht's rows X's columns, each
    factor replicated (on X's first device) where its axis is not sharded.
    Unchanged when X is one tensor."""
    if not isinstance(X, Shards):
        return W0, Ht0
    if X.axis == 0:
        if not isinstance(W0, Shards):
            W0 = shard_like(W0, X, axis=1)
        return W0, Ht0.to(X.device)
    if not isinstance(Ht0, Shards):
        Ht0 = shard_like(Ht0, X, axis=1)
    return W0.to(X.device), Ht0


def shard_products_rows(gram, P, W0):
    """Row-shard the products-given refit (the over-limit atlas consensus,
    cnmf_tpu/pipeline/solvers.py:881-926): P and W0 (B, M, K) split along M
    over every local device (zero rows appended: a zero P row keeps its zero
    W row at 0 and adds nothing to the violation), the (B, K, K) gram kept
    on the first device and replicated by the solve. The products-given CD
    is row-parallel, coupled only through the stop rule's summed violation.

    Returns (gram, P, W0, M), P and W0 as ``Shards``. A no-op (the inputs
    as given) with fewer than two local devices, local devices of another
    type than P's, or ``CNMF_TPU_MESH_PRODUCTS=0``."""
    n_rows = P.shape[1]
    devices = parallel_mesh.local_devices()
    if (len(devices) < 2
            or os.environ.get("CNMF_TPU_MESH_PRODUCTS", "1") == "0"
            or any(torch.device(d).type != P.device.type for d in devices)):
        return gram, P, W0, n_rows
    devices = build_mesh(devices).flat_devices()
    return (gram, split_rows(P, devices, axis=1),
            split_rows(W0, devices, axis=1), n_rows)


def _placement(X, device, dtype):
    """(device, numpy dtype) of a refit: a tensor X's own, or ``device`` and
    ``dtype`` (numpy or torch) for a host X."""
    if isinstance(X, (torch.Tensor, Shards)):
        device, dtype = X.device, X.dtype
    elif device is None or dtype is None:
        raise ValueError("a host X needs device= and dtype=")
    return torch.device(device), numpy_dtype(dtype)


def _dense_on(X, device, np_dtype) -> torch.Tensor:
    """A tensor (or ``Shards``) X as it is; a host X densified (natively,
    when sparse) at ``np_dtype`` and put on ``device``."""
    if isinstance(X, (torch.Tensor, Shards)):
        return X
    return torch.as_tensor(
        np.ascontiguousarray(densify_csr(X, out_dtype=np_dtype)), device=device)


def _cd_from_products(gram, P, nmf_kwargs, l1_reg, l2_reg,
                      shard_rows: bool = False):
    """The products-given CD NNLS from zeros (sklearn's CD refit init);
    ``shard_rows``: through ``shard_products_rows``."""
    W0 = torch.zeros_like(P)
    if shard_rows:
        gram, P, W0, _ = shard_products_rows(gram, P, W0)
    W, _ = nnls_cd_from_products(
        gram, P, W0, tol=float(nmf_kwargs.get("tol", 1e-4)),
        max_iter=int(nmf_kwargs.get("max_iter", 200)),
        l1_reg=l1_reg, l2_reg=l2_reg,
    )
    return W


def refit_spectra_transposed(X, usages: np.ndarray, nmf_kwargs: dict, *,
                             device=None, dtype=None) -> np.ndarray:
    """Fixed-usage spectra refit via the transpose trick (reference
    cnmf.py:805-820, 948-955) without materializing Xᵀ: the CD refit needs
    only the usage gram and Xᵀ·U; the MU refit is the usage refit of Xᵀ, a
    transposed view that the kernels read through its strides.

    X: (cells × genes) tensor, row ``Shards`` (Xᵀ·U and the usage gram
    summed over shards; the MU refit on Xᵀ's column shards), or a host
    matrix with ``device`` and ``dtype`` given. A sparse host X (the atlas
    consensus) is the usage refit of its transpose, whose CD path takes Xᵀ·U
    by host SpMM, so it never goes dense anywhere; it is CD-only, as in the
    JAX package (cnmf_tpu/pipeline/solvers.py:806-879). usages: (cells ×
    k). Returns spectra in X's units, transposed: (genes × k), as a host
    array. The regularization scales with the real cell count."""
    dev, np_dtype = _placement(X, device, dtype)
    if sp.issparse(X):
        if _is_mu(nmf_kwargs):
            raise ValueError(
                "refit_spectra_transposed: sparse X is CD-only; the MU "
                "spectra refit of a host TPM goes in gene chunks "
                "(stages.consensus_arrays)")
        return refit_usages(X.T, np.ascontiguousarray(usages.T), nmf_kwargs,
                            device=dev, dtype=np_dtype)
    if _is_mu(nmf_kwargs):
        Xd = _dense_on(X, dev, np_dtype)
        return refit_usages(Xd.T, np.ascontiguousarray(usages.T), nmf_kwargs)
    k = usages.shape[1]
    pad_k = pad_bucket(k)
    U = np.pad(np.ascontiguousarray(usages, dtype=np_dtype),
               ((0, 0), (0, pad_k - k)))
    # the materialized-transpose solve's X is (genes × cells): n_features is
    # the cell count
    l1_reg_W, _, l2_reg_W, _ = _regularization(
        nmf_kwargs, (X.shape[1], X.shape[0])
    )
    if isinstance(X, Shards):
        Us = shard_like(U, X)
        gram = sum_shards([fixed_factor_gram(u[None]) for u in Us.parts])
        P = sum_shards([fixed_factor_product_transposed(u, x)
                        for u, x in zip(Us.parts, X.parts)])
    else:
        Ud = torch.as_tensor(U, device=dev)
        gram = fixed_factor_gram(Ud[None])
        P = fixed_factor_product_transposed(Ud, _dense_on(X, dev, np_dtype))
    W = _cd_from_products(gram, P, nmf_kwargs, l1_reg_W, l2_reg_W)
    return W[0, :, :k].cpu().numpy()


def refit_usages(X, spectra: np.ndarray, nmf_kwargs: dict, *, device=None,
                 dtype=None) -> np.ndarray:
    """Fixed-spectra NNLS usage refit (sklearn update_H=False semantics;
    reference cnmf.py:776-802), W started by ``nnls_w_init``.

    X: (cells × genes) tensor, ``Shards`` (of its rows: W's rows follow
    them, padded rows stay 0; or of its columns: the spectra refit of a
    row-sharded TPM, the fixed factor's rows following them), or a host
    matrix with ``device`` and ``dtype`` given. A sparse host X never goes
    dense on the CD path: the refit takes the spectra gram and P = X·Hᵀ by
    one host SpMM at the compute dtype, and the device runs the (cells × k)
    products-given loop from zeros (cnmf_tpu/pipeline/solvers.py:963-996),
    row-sharded over the local devices where there are several
    (``shard_products_rows``). MU needs the reconstruction against X
    itself, so a sparse X is densified on the host (natively) and uploaded.
    spectra: (k × genes). Returns usages (cells × k) as a host array."""
    dev, np_dtype = _placement(X, device, dtype)
    k = spectra.shape[0]
    pad_k = pad_bucket(k)
    Ht = np.pad(np.ascontiguousarray(np.asarray(spectra).T, dtype=np_dtype),
                ((0, 0), (0, pad_k - k)))
    Ht0 = torch.as_tensor(Ht, device=dev)[None]
    if sp.issparse(X) and not _is_mu(nmf_kwargs):
        l1_reg_W, _, l2_reg_W, _ = _regularization(nmf_kwargs, X.shape)
        P = torch.as_tensor(np.ascontiguousarray(X @ Ht, dtype=np_dtype),
                            device=dev)[None]
        W = _cd_from_products(fixed_factor_gram(Ht0), P, nmf_kwargs,
                              l1_reg_W, l2_reg_W, shard_rows=True)
        return _host_usages(W, k)
    Xd = _dense_on(X, dev, np_dtype)
    W0 = nnls_w_init(Xd, k, "mu" if _is_mu(nmf_kwargs) else "cd", pad_k=pad_k)
    W0, Ht0 = _match_factor_shardings(Xd, W0, Ht0)
    W, _, _ = solve_nmf_batch(Xd, W0, Ht0, nmf_kwargs, update_H=False)
    return _host_usages(W, k)


def _host_usages(W, k: int) -> np.ndarray:
    """Restart 0's first k columns of a refit's W (a tensor, or row
    ``Shards`` whose real rows are gathered) as a host array."""
    if isinstance(W, Shards):
        W = gather_shards(W)
    return W[0, :, :k].cpu().numpy()
