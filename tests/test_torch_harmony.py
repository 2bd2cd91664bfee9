"""The port's Harmony (cnmf_tpu_torch.harmony) against the JAX package's and
against an independent float64 oracle, on the CPU.

The fixture is tests/test_harmony_oracle.py's (two batches of 120 cells in 8
dimensions, 6 clusters, 3 Harmony iterations of 5 clustering rounds, early
stopping off); the oracle is a plain-loop float64 transcription of the
published algorithm, written out again here. Both packages draw the same
kmeans++ centres and the same block-permutation pool, so R and the corrected
embedding agree within the 5e-4 (× scale) the JAX package is held to against
that oracle. With the default epsilons both stop after the same number of
iterations on that fixture; ``moe_correct_ridge_X`` fed the JAX package's
converged state agrees within 1e-5 × max. Two more fixtures (N = 250 and
241) leave the last of the 20 blocks short or, in JAX's padded layout,
empty.
"""

import numpy as np
import pandas as pd
import pytest

from cnmf_tpu import harmony as jax_harmony
from cnmf_tpu.ops.kmeans import kmeans_fit
from cnmf_tpu_torch import harmony as torch_harmony
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

MAX_H = 3
MAX_K = 5
SIGMA = 0.1
BLOCK_SIZE = 0.05
SEED = 0
NCLUST = 6
ORACLE_ABS = 5e-4
MOE_X_REL = 1e-5


def make_batches(n_a=120, n_b=120):
    """Batch a: n_a cells; batch b: the first n_b of the same cells,
    stretched and shifted."""
    rng = np.random.RandomState(7)
    d = 8
    base = rng.standard_normal((max(n_a, n_b), d))
    shift = rng.standard_normal(d) * 1.5
    Z = np.vstack([base[:n_a],
                   base[:n_b] @ np.diag(1 + 0.1 * rng.rand(d)) + shift])
    meta = pd.DataFrame({"batch": ["a"] * n_a + ["b"] * n_b})
    return Z.astype(np.float64), meta


@pytest.fixture(scope="module")
def batch_data():
    return make_batches()


def oracle_harmony(Z_rows, meta, nclust):
    """Loop-based float64 Harmony from the same kmeans++ centres and the
    same permutation pool (RandomState(SEED)) as both packages; returns
    (Z_corr (d, N), R, Phi_moe, lamb_diag)."""
    N, _ = Z_rows.shape
    Z_orig = Z_rows.T.astype(np.float64)
    Z_cos = Z_orig / np.maximum(np.linalg.norm(Z_orig, axis=0), 1e-12)
    phi = pd.get_dummies(meta["batch"]).T.to_numpy().astype(np.float64)
    Pr_b = phi.sum(axis=1) / N
    theta = np.ones(phi.shape[0])
    lamb_diag = np.diag(np.insert(np.ones(phi.shape[0]), 0, 0.0))
    Phi_moe = np.vstack([np.ones(N), phi])

    _, centers, _ = kmeans_fit(Z_cos.T.astype(np.float32), n_clusters=nclust,
                               n_init=10, random_state=SEED, max_iter=25)
    Y = centers.T.astype(np.float64)
    Y /= np.maximum(np.linalg.norm(Y, axis=0), 1e-12)
    rng = np.random.RandomState(SEED)
    n_blocks = int(np.ceil(1.0 / BLOCK_SIZE))
    L = int(np.ceil(N / n_blocks))
    pool = [rng.permutation(N) for _ in range(MAX_K)]

    def soft(Y):
        S = -2.0 * (1.0 - Y.T @ Z_cos) / SIGMA
        return np.exp(S - S.max(axis=0, keepdims=True))

    R = soft(Y)
    R /= R.sum(axis=0, keepdims=True)
    E = np.outer(R.sum(axis=1), Pr_b)
    O = R @ phi.T
    round_idx = 0
    for _ in range(MAX_H):
        for _ in range(MAX_K):
            S = soft(Y)
            perm = pool[round_idx % MAX_K]
            round_idx += 1
            for b in range(n_blocks):
                cells = perm[b * L:(b + 1) * L]
                Rb, phib = R[:, cells], phi[:, cells]
                E -= np.outer(Rb.sum(axis=1), Pr_b)
                O -= Rb @ phib.T
                pen = np.power((E + 1.0) / (O + 1.0), theta[None, :]) @ phib
                R_new = S[:, cells] * pen
                R_new /= np.abs(R_new).sum(axis=0, keepdims=True)
                E += np.outer(R_new.sum(axis=1), Pr_b)
                O += R_new @ phib.T
                R[:, cells] = R_new
            Y = Z_cos @ R.T
            Y /= np.maximum(np.linalg.norm(Y, axis=0), 1e-12)
        Z_corr = Z_orig.copy()
        for i in range(nclust):
            Phi_Rk = Phi_moe * R[i][None, :]
            W = np.linalg.solve(Phi_Rk @ Phi_moe.T + lamb_diag,
                                Phi_Rk @ Z_orig.T)
            W[0, :] = 0.0
            Z_corr -= W.T @ Phi_Rk
        Z_cos = Z_corr / np.maximum(np.linalg.norm(Z_corr, axis=0), 1e-12)
    return Z_corr, R, Phi_moe, lamb_diag


def fixed_round_runs(Z, meta):
    kw = dict(sigma=SIGMA, nclust=NCLUST, block_size=BLOCK_SIZE,
              max_iter_harmony=MAX_H, max_iter_kmeans=MAX_K,
              epsilon_cluster=-1.0, epsilon_harmony=-1.0, random_state=SEED)
    return dict(
        jax=jax_harmony.run_harmony(Z, meta, ["batch"], **kw),
        torch=torch_harmony.run_harmony(Z, meta, ["batch"], device="cpu",
                                        **kw),
        oracle=oracle_harmony(Z, meta, NCLUST),
    )


@pytest.fixture(scope="module")
def runs(batch_data):
    return fixed_round_runs(*batch_data)


def test_responsibilities_match_jax_and_oracle(runs):
    R_oracle = runs["oracle"][1]
    assert runs["torch"].R.shape == R_oracle.shape
    np.testing.assert_allclose(runs["torch"].R, runs["jax"].R, atol=ORACLE_ABS)
    for pkg in ("torch", "jax"):
        np.testing.assert_allclose(runs[pkg].R, R_oracle, atol=ORACLE_ABS)


def test_corrected_embedding_matches_jax_and_oracle(runs):
    Z_oracle = runs["oracle"][0].T
    scale = np.abs(Z_oracle).max()
    np.testing.assert_allclose(runs["torch"].Z_corr, runs["jax"].Z_corr,
                               atol=ORACLE_ABS * scale)
    for pkg in ("torch", "jax"):
        np.testing.assert_allclose(runs[pkg].Z_corr, Z_oracle,
                                   atol=ORACLE_ABS * scale)
    assert runs["torch"].iterations == MAX_H
    assert runs["torch"].rounds == MAX_H * MAX_K


@pytest.mark.parametrize("n_b", [130, 121])
def test_ragged_last_block_matches_jax_and_oracle(n_b):
    """N not divisible by the 20 blocks. N = 250: the last block holds 3
    cells. N = 241: JAX's 20th block is all padding (19 blocks of 13 cover
    the cells), which the port does not run. R and the corrected embedding
    agree with JAX and the oracle as on the even fixture."""
    Z, meta = make_batches(120, n_b)
    got = fixed_round_runs(Z, meta)
    R_oracle, Z_oracle = got["oracle"][1], got["oracle"][0].T
    scale = np.abs(Z_oracle).max()
    assert got["torch"].R.shape == R_oracle.shape == (NCLUST, 120 + n_b)
    np.testing.assert_allclose(got["torch"].R, got["jax"].R, atol=ORACLE_ABS)
    np.testing.assert_allclose(got["torch"].Z_corr, got["jax"].Z_corr,
                               atol=ORACLE_ABS * scale)
    for pkg in ("torch", "jax"):
        np.testing.assert_allclose(got[pkg].R, R_oracle, atol=ORACLE_ABS)
        np.testing.assert_allclose(got[pkg].Z_corr, Z_oracle,
                                   atol=ORACLE_ABS * scale)


def test_design_and_penalty_match_jax(runs):
    np.testing.assert_array_equal(runs["torch"].Phi_moe, runs["jax"].Phi_moe)
    np.testing.assert_array_equal(runs["torch"].lamb, runs["jax"].lamb)
    assert runs["torch"].K == runs["jax"].K == NCLUST


def test_default_epsilons_same_iterations(batch_data):
    """The fixture with the default epsilons: both packages stop after the
    same Harmony iterations (7) with the same responsibilities. (The stop
    rules compare float32 objectives; on other inputs a clustering round's
    relative change can land within the last bits of epsilon_cluster, and
    the two then part by a round.)"""
    Z, meta = batch_data
    want = jax_harmony.run_harmony(Z, meta, "batch", max_iter_harmony=20)
    got = torch_harmony.run_harmony(Z, meta, "batch", max_iter_harmony=20,
                                    device="cpu")
    assert len(want.objective_harmony) < 20
    assert got.iterations == len(got.objective_harmony) \
        == len(want.objective_harmony)
    np.testing.assert_allclose(got.objective_harmony, want.objective_harmony,
                               rtol=1e-5)
    np.testing.assert_allclose(got.R, want.R, atol=ORACLE_ABS)


@pytest.mark.parametrize("theta,lamb,tau", [(2.0, 0.5, 0),
                                            ([1.0, 3.0], [2.0, 1.0], 5)])
def test_theta_lambda_tau_match_jax(theta, lamb, tau):
    """Two batch variables (one with three levels): the per-level theta and
    lambda broadcasting and the tau term, over two iterations of fixed
    rounds."""
    rng = np.random.RandomState(1)
    Z = rng.normal(0, 1, size=(200, 12)).astype(np.float32)
    batch = np.array(["a", "b"] * 100)
    Z[batch == "b"] += 1.0
    obs = pd.DataFrame({"batch": batch,
                        "donor": np.array(["x", "y", "z", "x"] * 50)})
    kw = dict(theta=theta, lamb=lamb, tau=tau, max_iter_harmony=2,
              max_iter_kmeans=5, epsilon_cluster=-1.0, epsilon_harmony=-1.0,
              random_state=0)
    want = jax_harmony.run_harmony(Z, obs, ["batch", "donor"], **kw)
    got = torch_harmony.run_harmony(Z, obs, ["batch", "donor"], device="cpu",
                                    **kw)
    np.testing.assert_array_equal(got.lamb, want.lamb)
    np.testing.assert_array_equal(got.Phi_moe, want.Phi_moe)
    np.testing.assert_allclose(got.objective_harmony, want.objective_harmony,
                               rtol=1e-5)
    np.testing.assert_allclose(got.R, want.R, atol=ORACLE_ABS)
    np.testing.assert_allclose(got.Z_corr, want.Z_corr,
                               atol=ORACLE_ABS * np.abs(want.Z_corr).max())


def test_moe_correct_x_matches_jax(runs, batch_data):
    """The X-space correction with the JAX package's converged state,
    chunked and clipped at 0."""
    Z, _ = batch_data
    state = runs["jax"]
    X = np.abs(np.random.RandomState(1).standard_normal((Z.shape[0], 30))) * 3
    want = jax_harmony.moe_correct_ridge_X(X, state, chunk_genes=16)
    given = torch_harmony.HarmonyResult(state.Z_corr, state.R, state.Phi_moe,
                                        state.lamb, state.K, [], device="cpu")
    got = torch_harmony.moe_correct_ridge_X(X, given, chunk_genes=16)
    assert got.dtype == np.float32 and (got >= 0).all()
    np.testing.assert_allclose(got, want, atol=MOE_X_REL * np.abs(want).max())


def test_harmony_deterministic():
    rng = np.random.RandomState(1)
    Z = rng.normal(0, 1, size=(200, 12)).astype(np.float32)
    obs = pd.DataFrame({"batch": np.array(["a", "b"] * 100)})
    r1 = torch_harmony.run_harmony(Z, obs, "batch", max_iter_harmony=3,
                                   device="cpu")
    r2 = torch_harmony.run_harmony(Z, obs, "batch", max_iter_harmony=3,
                                   device="cpu")
    np.testing.assert_array_equal(r1.Z_corr, r2.Z_corr)
    np.testing.assert_array_equal(r1.R, r2.R)


def test_harmony_defaults_to_the_card(runs, batch_data):
    """run_harmony and HarmonyResult default to CUDA: a result built as the
    JAX API builds it (positionally, no device) runs the X correction on
    the card, and raises on a machine without one."""
    import inspect

    import torch

    for fn in (torch_harmony.run_harmony, torch_harmony.HarmonyResult):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    state = runs["jax"]
    given = torch_harmony.HarmonyResult(state.Z_corr, state.R, state.Phi_moe,
                                        state.lamb, state.K, [])
    assert given.device.type == "cuda"
    if torch.cuda.is_available():
        return
    X = np.ones((batch_data[0].shape[0], 4))
    with pytest.raises((RuntimeError, AssertionError)):
        torch_harmony.moe_correct_ridge_X(X, given)
