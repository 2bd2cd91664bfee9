"""The host-side layout of the TF32 kernels' staged operands
(``ops.mu_kernels.tf32_stage_order``, ``tf32_stage_plain``, ``TF32_PERM``;
``csrc/mu_tf32.cu``'s ``stage_kernel`` writes the same floats on a card,
held bit for bit in tests/test_torch_tf32_card.py).

For each restart and chunk of ``chunk`` entries of the contracted factor Fo
(C, K) the staging holds two TF32 copies: the S product's operand
[K/4][chunk][4] (entry-major rows of 4 k values), then the second
product's [chunk/4][K][4] whose entries run, within each 8, in the order
0 2 4 6 1 3 5 7: the product takes S's accumulator column 2t as its k = t
and 2t + 1 as its k = t + 4. The tests hold the order to a permutation
written out here, check that each half holds every (entry, k) once at every
register bucket, hold the plain staging to a loop, and replay both products
through the operand layouts with that relabelling, in numpy, against P · Fo
and F · Foᵀ."""

import numpy as np
import pytest
import torch

from cnmf_tpu_torch.ops import mu_kernels as mk
from torch_knobs import one_torch_thread  # noqa: F401 (autouse)

BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64)
CHUNK = 32   # the kernels' chunk (csrc/mu_tf32.cu, hop::kCC)

# tf32_stage_order(8, 8), written out: the S half's entries and k, then the
# second half's
S_ENTRY = [e for _ in range(2) for e in range(8) for _ in range(4)]
S_K = [k for h in range(2) for _ in range(8) for k in range(4 * h, 4 * h + 4)]
T_ENTRY = ([0, 2, 4, 6] * 8) + ([1, 3, 5, 7] * 8)
T_K = [k for _ in range(2) for k in range(8) for _ in range(4)]


def test_stage_order_is_the_written_permutation():
    entry, k = mk.tf32_stage_order(8, 8)
    assert entry.tolist() == S_ENTRY + T_ENTRY
    assert k.tolist() == S_K + T_K
    assert mk.TF32_PERM == (0, 2, 4, 6, 1, 3, 5, 7)


@pytest.mark.parametrize("K", BUCKETS)
def test_stage_order_holds_each_entry_once(K):
    entry, k = mk.tf32_stage_order(K, CHUNK)
    n = CHUNK * K
    assert entry.shape == k.shape == (2 * n,)
    for half in (slice(0, n), slice(n, 2 * n)):
        flat = entry[half] * K + k[half]
        assert sorted(flat.tolist()) == list(range(n))


@pytest.mark.parametrize("B,C,K,Bp,chunk", [
    (1, 5, 8, 3, 8), (3, 70, 16, 4, 32), (2, 33, 24, 2, 32)])
def test_stage_plain_matches_a_loop(B, C, K, Bp, chunk):
    rng = np.random.RandomState(C)
    F = rng.rand(B, C, K).astype(np.float32)
    got = mk.tf32_stage_plain(torch.as_tensor(F), Bp, chunk).numpy()
    rounded = mk.tf32_round(torch.as_tensor(F)).numpy()
    nq = -(-C // chunk)
    want = np.zeros((nq, Bp, 2 * chunk * K), np.float32)
    perm = mk.TF32_PERM
    for q in range(nq):
        for b in range(B):
            for c in range(chunk):
                for kk in range(K):
                    if q * chunk + c >= C:
                        continue
                    v = rounded[b, q * chunk + c, kk]
                    want[q, b, (kk // 4) * 4 * chunk + 4 * c + kk % 4] = v
                    p = c // 8 * 8 + perm.index(c % 8)
                    want[q, b, chunk * K + (p // 4) * 4 * K + 4 * kk
                         + p % 4] = v
    assert np.array_equal(got, want)


@pytest.mark.parametrize("K", BUCKETS)
def test_staged_operands_replay_both_products(K):
    """S = F · Fo_chunkᵀ from the first half as K/8 k-steps of (8 k x chunk)
    operands, and P · Fo_chunk from the second as chunk/8 steps whose A
    fragment takes S's accumulator columns (2t, 2t + 1) as k = (t, t + 4)."""
    rng = np.random.RandomState(K)
    Fo = rng.rand(1, CHUNK, K)
    F = rng.rand(64, K)
    P = rng.rand(64, CHUNK)
    staged = mk.tf32_stage_plain(torch.as_tensor(Fo, dtype=torch.float32), 1,
                                 CHUNK)[0, 0].double().numpy()
    fo = mk.tf32_round(torch.as_tensor(Fo[0], dtype=torch.float32)).double()
    fo = fo.numpy()
    n = CHUNK * K
    # first half: k-step ks holds k groups 2ks, 2ks + 1, each [chunk][4]
    s_half = staged[:n].reshape(K // 4, CHUNK, 4)
    S = sum(F[:, 8 * ks:8 * ks + 8]
            @ np.concatenate([s_half[2 * ks], s_half[2 * ks + 1]], axis=1).T
            for ks in range(K // 8))
    assert np.allclose(S, F @ fo.T, rtol=1e-12, atol=0)
    # second half: step j holds position groups 2j, 2j + 1, each [K][4]
    t_half = staged[n:].reshape(CHUNK // 4, K, 4)
    acc = np.zeros((64, K))
    for j in range(CHUNK // 8):
        b = np.concatenate([t_half[2 * j], t_half[2 * j + 1]], axis=1).T
        # the accumulator's columns of this step: (2t, 2t + 1) for t = 0..3
        cols = 8 * j + np.array([2 * t + e for e in (0, 1) for t in range(4)])
        acc += P[:, cols] @ b
    assert np.allclose(acc, P @ fo, rtol=1e-12, atol=0)


# --- the TF32 divergence term's partials (``kl_x_log_wh_tf32``) ---

def _divergence_problem(B, N, G, K, seed):
    rng = np.random.RandomState(seed)
    X = (rng.gamma(1.0, 1.0, (N, G)) * (rng.rand(N, G) > 0.4)).astype(
        np.float32)
    X[rng.rand(N, G) < 0.05] = 1e-8   # nonzero but not above eps
    avg = np.sqrt(X.mean() / K)
    W = (avg * np.abs(rng.randn(B, N, K))).astype(np.float32)
    Ht = (avg * np.abs(rng.randn(B, G, K))).astype(np.float32)
    W[:, 3] = 0.0   # a zero row: S floored at eps along it
    return (torch.as_tensor(a) for a in (X, W, Ht))


@pytest.mark.parametrize("K", BUCKETS + (72,))
def test_divergence_partials_sum_to_the_twin(K):
    """Per tile of ``tf32_rows(K)`` rows and restart, the partials summed
    over their tiles are the twin's sum in float64 (the rounded factors),
    and the f32 twin to f32's rounding."""
    B, N, G = 3, 300, 41
    X, W, Ht = _divergence_problem(B, N, G, K, K)
    part = mk.kl_x_log_wh_tf32_partials_plain(X, W, Ht)
    rows = mk.tf32_rows(K)
    assert part.shape == (-(-N // rows), B) and part.dtype == torch.float64
    exact = mk.kl_x_log_wh_plain(X.double(), mk.tf32_round(W).double(),
                                 mk.tf32_round(Ht).double())
    torch.testing.assert_close(part.sum(dim=0), exact, rtol=1e-12, atol=0)
    torch.testing.assert_close(part.sum(dim=0).float(),
                               mk.kl_x_log_wh_tf32_plain(X, W, Ht),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("rows", (128, 32, 7))
def test_divergence_partial_is_its_rows_sum(rows):
    """Tile i's partial is the sum over rows i·rows .. (i + 1)·rows of W
    alone; the last tile is ragged."""
    X, W, Ht = _divergence_problem(2, 300, 50, 16, rows)
    part = mk.kl_x_log_wh_tf32_partials_plain(X, W, Ht, rows=rows)
    Wr, Htr = (mk.tf32_round(t).double() for t in (W, Ht))
    for i in range(part.shape[0]):
        sl = slice(i * rows, (i + 1) * rows)
        want = mk.kl_x_log_wh_plain(X[sl].double(), Wr[:, sl], Htr)
        torch.testing.assert_close(part[i], want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("K,rows", [(K, 128) for K in BUCKETS]
                         + [(72, 32), (136, 32), (12, 0), (0, 0), (4, 0)])
def test_tf32_rows_mirror(K, rows):
    """``tf32_rows`` mirrors ``mu_tf32_rows``: the Hopper kernel's 128 rows
    a block at every register bucket, the mma.sync kernel's 32 at a wide K,
    0 where no kernel takes K (held to the library's in
    tests/test_torch_tf32_card.py)."""
    assert mk.tf32_rows(K) == rows
