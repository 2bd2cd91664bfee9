"""The port's float32 product precision (``utils.precision``,
CNMF_TPU_MATMUL_PRECISION) on the CPU, and the JAX package's MU precision
ladder knob, which the port does not take.

The ladder's coarse phase needs relaxed (TF32 or bfloat16) variants of the
hand-written MU kernels, and the port has none yet, so
CNMF_TPU_MU_PRECISION_LADDER is the JAX package's alone: with it set, the
port's MU solve is its one-phase solve, bit for bit."""

import numpy as np
import pytest
import torch

from cnmf_tpu.ops.init import random_init_batch
from cnmf_tpu_torch.ops import nmf as pt_nmf
from cnmf_tpu_torch.pipeline import solvers
from cnmf_tpu_torch.utils import precision
from torch_handoff import one_torch_thread  # noqa: F401 (autouse)
from torch_knobs import host_draws_by_default  # noqa: F401 (autouse)


def _problem(seed=4, n=60, g=45, k=4, b=6):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.randn(n, g)) + 0.05
    seeds = rng.randint(1, 2**31 - 1, size=b)
    W0, Ht0 = random_init_batch(X, k, seeds, dtype=np.float64)
    return X, W0, Ht0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("name,mode,tf32", [
    (None, "highest", False), ("highest", "highest", False),
    ("high", "high", True), ("default", "medium", True)])
def test_matmul_precision_knob(monkeypatch, name, mode, tf32):
    """CNMF_TPU_MATMUL_PRECISION → torch's float32 mode, as the package
    sets it on import (unset: full float32, TF32 off)."""
    if name is None:
        monkeypatch.delenv("CNMF_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("CNMF_TPU_MATMUL_PRECISION", name)
    before = _flags()
    try:
        precision.set_mode(precision.knob_mode())
        assert _flags() == (mode, tf32, tf32)
    finally:
        precision.set_mode(before[0])
    assert _flags() == before
    monkeypatch.setenv("CNMF_TPU_MATMUL_PRECISION", "bf16")
    with pytest.raises(ValueError, match="CNMF_TPU_MATMUL_PRECISION"):
        precision.knob_mode()


@pytest.mark.parametrize("beta_loss", ["kullback-leibler", "itakura-saito"])
def test_mu_ladder_knob_keeps_the_one_phase_solve(monkeypatch, beta_loss):
    """CNMF_TPU_MU_PRECISION_LADDER=1 (the JAX package's ladder) leaves the
    port's MU solve, at the betas the JAX ladder takes, as it is unset, and
    torch's product precision at full float32."""
    X, W0, Ht0 = _problem()
    kwargs = {"solver": "mu", "beta_loss": beta_loss, "tol": 1e-4,
              "max_iter": 60}
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("CNMF_TPU_MU_PRECISION_LADDER", mode)
        out[mode] = solvers.solve_nmf_batch(_t(X), _t(W0), _t(Ht0), kwargs)
        assert _flags() == ("highest", False, False)
    assert all(torch.equal(a, b) for a, b in zip(out["0"], out["1"]))
    ref = pt_nmf.nmf_multiplicative_update(
        _t(X), _t(W0), _t(Ht0),
        beta=solvers.beta_loss_to_float(beta_loss), tol=1e-4, max_iter=60)
    assert all(torch.equal(a, b) for a, b in zip(out["1"], ref))
