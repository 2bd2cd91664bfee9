"""Fixtures the port's CPU test modules share. ``one_torch_thread``: every
module's torch ops on one intra-op thread. ``host_draws_by_default``: the
knobs of the
threefry-seeded paths, the one-program consensus, the compact TPM and the
stage hand-off (the spectra twin, the background writer and its drain,
the packing, the arena, the phase split, the storage dtype, the npz codec;
the tail-compacting schedules, the MU precision ladder, the autowarm and
the matmul precision, which the package reads when it is imported;
CNMF_TPU_DRAIN_HOLD_S, CNMF_TPU_PACK_ALL and CNMF_TPU_STAGED_S0 are the JAX
package's alone, read by its parity runs) unset for a module, so its runs take the CPU's defaults — the host's
sklearn-exact draws (``solvers.device_init_enabled``,
``device_kmeanspp_enabled``), the one-program consensus seeded on the host,
the TPM prefetch — whatever an earlier module of the process left in the
environment (``__graft_entry__.dryrun_multichip`` sets
``CNMF_TPU_DEVICE_INIT=force`` for the rest of its process). A test that
sets a knob itself still does. Import a fixture by name into a test module
to use it."""

import pytest
import torch

KNOBS = ("CNMF_TPU_DEVICE_INIT", "CNMF_TPU_DEVICE_KMEANSPP",
         "CNMF_TPU_FUSED_CONSENSUS", "CNMF_TPU_DEVICE_TPM",
         "CNMF_TPU_PREFETCH_TPM", "CNMF_TPU_DEVICE_NORM",
         "CNMF_TPU_CSR_UPLOAD", "CNMF_TPU_DEVICE_SPECTRA",
         "CNMF_TPU_ASYNC_WRITES", "CNMF_TPU_DRAIN_HOLD_S",
         "CNMF_TPU_PACK_ALL", "CNMF_TPU_HOST_ARENA", "CNMF_TPU_PHASES",
         "CNMF_TPU_PREPARE_DTYPE", "CNMF_TPU_COMPRESS",
         "CNMF_TPU_STAGED", "CNMF_TPU_STAGED_S0", "CNMF_TPU_GRID",
         "CNMF_TPU_COMPACT", "CNMF_TPU_MU_PRECISION_LADDER",
         "CNMF_TPU_AUTOWARM", "CNMF_TPU_MATMUL_PRECISION")


@pytest.fixture(autouse=True, scope="module")
def host_draws_by_default():
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv(knob, raising=False)
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread (restored after):
    its tensors are tiny, and beside the other test workers the default
    thread count oversubscribes the cores, where each op's parallel region
    stalls (the five stage hand-off files took 764 s under ``-n 4`` with
    eight threads a process, 36 s with one; under ``-n 6 --dist loadfile``
    tests/test_torch_ladder.py's tests took 561 s in all with eight, 9.5 s
    with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
