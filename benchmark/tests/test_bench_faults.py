"""A run of the harness on the CPU at a small size (its look for a card
skipped) comes out correct, and with the timed path broken underneath it
comes out not correct, once for each fault a cell can have:

* a step that returns its state unchanged (the CD half-sweeps; the MU
  updates);
* half of the restart batch left out (solved for the first half only);
* an answer altered where it is produced (the normalized counts, the
  consensus usages, a k-selection silhouette, one restart's spectra).

The exchange between chips is no fault here: every cell runs on one chip.
"""

import numpy as np
import pytest
import torch

from tiny import run_tiny, tiny_cell

LOSSES = ["frobenius", "kullback-leibler"]


@pytest.mark.parametrize("loss", LOSSES)
def test_sound_run_is_correct(loss, cpu_knobs):
    rc, res = run_tiny(tiny_cell(beta_loss=loss))
    assert rc == 0 and res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


def unchanged_step(monkeypatch, loss):
    from cnmf_tpu_torch.ops import nmf

    if loss == "frobenius":
        for name in ("cd_w_half_sweep", "cd_h_half_sweep"):
            real = getattr(nmf, name)

            def same(X, W, Ht, _real=real, _name=name, **kw):
                new, viol = _real(X, W, Ht, **kw)
                return (W if _name == "cd_w_half_sweep" else Ht), viol
            monkeypatch.setattr(nmf, name, same)
    else:
        monkeypatch.setattr(nmf, "_mu_update_w", lambda X, W, *a, **k: W)
        monkeypatch.setattr(nmf, "_mu_update_h", lambda X, W, Ht, *a, **k: Ht)


def half_batch(monkeypatch, loss):
    from cnmf_tpu_torch.pipeline import stages

    real = stages.solve_nmf_batch

    def first_half(X, W0, Ht0, kwargs, **kw):
        h = max(1, W0.shape[0] // 2)
        W, Ht, n = real(X, W0[:h], Ht0[:h], kwargs, **kw)
        return (torch.cat([W, W0[h:]]), torch.cat([Ht, Ht0[h:]]),
                torch.cat([n, torch.zeros_like(n[:1]).expand(
                    W0.shape[0] - h)]))
    monkeypatch.setattr(stages, "solve_nmf_batch", first_half)


def altered_norm(monkeypatch, loss):
    from cnmf_tpu_torch.pipeline import stages

    real = stages.prepare_arrays

    def prep(*a, **k):
        out = real(*a, **k)
        out.norm = out.norm * 1.001
        return out
    monkeypatch.setattr(stages, "prepare_arrays", prep)


def altered_usages(monkeypatch, loss):
    from cnmf_tpu_torch.pipeline import stages

    real = stages.consensus_arrays

    def cons(*a, **k):
        out = real(*a, **k)
        out.usages = out.usages * 1.01
        return out
    monkeypatch.setattr(stages, "consensus_arrays", cons)


def altered_silhouette(monkeypatch, loss):
    from cnmf_tpu_torch.pipeline import stages

    real = stages.k_stats_arrays

    def rows(*a, **k):
        out = real(*a, **k)
        k0, dt, sil, err = out[0]
        return [(k0, dt, sil + 0.01, err)] + out[1:]
    monkeypatch.setattr(stages, "k_stats_arrays", rows)


def altered_spectra(monkeypatch, loss):
    from cnmf_tpu_torch.pipeline import stages

    real = stages.factorize_grid

    def grid(X_host, Xd, jobs, kwargs, write, **kw):
        def bent(k, iters, batch, twin):
            batch = np.array(batch)
            batch[:, 0] *= 1.01    # every restart's first program
            write(k, iters, batch, None)
        return real(X_host, Xd, jobs, kwargs, bent, **kw)
    monkeypatch.setattr(stages, "factorize_grid", grid)


FAULTS = [unchanged_step, half_batch, altered_norm, altered_usages,
          altered_silhouette, altered_spectra]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, loss, cpu_knobs, monkeypatch):
    fault(monkeypatch, loss)
    rc, res = run_tiny(tiny_cell(beta_loss=loss))
    assert rc == 0 and res["correct"] is False, res["checks"]
