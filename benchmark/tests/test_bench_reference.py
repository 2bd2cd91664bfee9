"""The plain reference's frozen copies against the port they stand in for,
on the CPU: the restart inits drawn from the seeds, the KMeans seeding and
Lloyd (the same labels, bit for bit), and prepare."""

import numpy as np
import pytest
import torch

from benchkit import cells, generate
from benchkit.reference import kmeans as ref_kmeans
from benchkit.reference import threefry
from benchkit.reference.prepare import prepare


@pytest.mark.parametrize("k", [5, 8, 13])
def test_restart_inits_are_the_ports(k):
    from cnmf_tpu_torch.ops.init import random_init_batch_device

    seeds = [12345, 2 ** 31 - 5]
    W, H = random_init_batch_device(0.37, 50, 40, k, seeds,
                                    pad_k=-(-k // 8) * 8, dtype=np.float32,
                                    device="cpu")
    for i, s in enumerate(seeds):
        w, h = threefry.restart_init(s, 0.37, k, 50, 40)
        np.testing.assert_allclose(w, W[i, :, :k].numpy(), rtol=1e-5)
        np.testing.assert_allclose(h, H[i, :, :k].numpy(), rtol=1e-5)


@pytest.mark.parametrize("k", [4, 6, 11])
def test_kmeans_labels_are_the_ports(k):
    from cnmf_tpu_torch.ops import kmeans as port, prng

    rng = np.random.default_rng(k)
    C = rng.gamma(1, 1, (8, 60))
    R = 700
    X = (C[rng.integers(0, 8, R)] * rng.gamma(5, 0.2, (R, 1))
         + rng.gamma(0.3, 0.3, (R, 60)))
    raw = torch.as_tensor(X, dtype=torch.float32)
    Xp = ref_kmeans.padded(raw / torch.sqrt((raw * raw).sum(1, keepdim=True)),
                           1024)
    w = (torch.arange(1024) < R).float()
    l2 = Xp[:R]
    tol = 1e-4 * torch.mean(torch.mean((l2 - l2.mean(0, keepdim=True)) ** 2,
                                       dim=0))
    trials = 2 + int(np.log(k))
    c0 = port.seed_kmeanspp_batch(Xp, w, R, k, prng.prng_key(1), n_init=10,
                                  n_cluster_pad=16 if k > 8 else 8,
                                  n_local_trials=trials)
    labels, inertia, _ = port._lloyd_batched(Xp, c0, tol, R, k, 300)
    mine = ref_kmeans.best_labels(Xp, R, k, tol)
    assert torch.equal(mine, labels[int(torch.argmin(inertia))][:R])


@pytest.mark.parametrize("name, rows", [("pbmc3k", 400), ("pbmc68k", 4000)])
def test_prepare_is_the_ports(name, rows):
    import scipy.sparse as sp

    from cnmf_tpu_torch.pipeline import stages

    cfg = dict(cells.load_json("configs", name), n_cells=rows)
    counts = generate.counts_for(cfg, cfg["data_seed"], "cpu")
    prep = stages.prepare_arrays(counts, num_highvar_genes=2000)
    _, std, hvgs, norm = prepare(counts, 2000)
    assert np.array_equal(np.sort(prep.hvg_idx), hvgs)
    a = prep.norm.toarray() if sp.issparse(prep.norm) else prep.norm
    b = norm.toarray() if sp.issparse(norm) else norm
    np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(prep.tpm_std, std, rtol=1e-6)
