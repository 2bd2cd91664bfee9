"""A fixture the port's CPU test modules share: the knobs of the
threefry-seeded paths, the one-program consensus, the compact TPM and the
stage hand-off (the spectra twin, the background writer and its drain,
the packing, the arena, the phase split, the storage dtype, the npz codec;
the tail-compacting schedules, the autowarm and the matmul precision,
which the package reads when it is imported; CNMF_TPU_DRAIN_HOLD_S,
CNMF_TPU_PACK_ALL, CNMF_TPU_STAGED_S0 and CNMF_TPU_MU_PRECISION_LADDER are
the JAX package's alone, read by its parity runs) unset for a module, so its runs take the CPU's defaults — the host's
sklearn-exact draws (``solvers.device_init_enabled``,
``device_kmeanspp_enabled``), the one-program consensus seeded on the host,
the TPM prefetch — whatever an earlier module of the process left in the
environment (``__graft_entry__.dryrun_multichip`` sets
``CNMF_TPU_DEVICE_INIT=force`` for the rest of its process). A test that
sets a knob itself still does. Import it into a test module to use it."""

import pytest

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
