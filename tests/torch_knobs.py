"""A fixture the port's CPU test modules share: the knobs of the
threefry-seeded paths unset for a module, so its runs take the CPU's
default, the host's sklearn-exact draws (``solvers.device_init_enabled``,
``device_kmeanspp_enabled``), whatever an earlier module of the process
left in the environment (``__graft_entry__.dryrun_multichip`` sets
``CNMF_TPU_DEVICE_INIT=force`` for the rest of its process). A test that
sets a knob itself still does. Import it into a test module to use it."""

import pytest

KNOBS = ("CNMF_TPU_DEVICE_INIT", "CNMF_TPU_DEVICE_KMEANSPP")


@pytest.fixture(autouse=True, scope="module")
def host_draws_by_default():
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv(knob, raising=False)
        yield
