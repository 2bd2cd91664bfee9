"""A fixture the port's CPU test modules share: the knobs of the
threefry-seeded paths, the one-program consensus and the compact TPM unset
for a module, so its runs take the CPU's defaults — the host's
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
         "CNMF_TPU_CSR_UPLOAD")


@pytest.fixture(autouse=True, scope="module")
def host_draws_by_default():
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv(knob, raising=False)
        yield
