"""The roofline's work models and the peak table, pinned by hand."""

import pytest

from benchkit import cells, peaks


def test_frobenius_work_by_hand():
    frob = cells.load_module("work", "frobenius")
    # N=10 cells, G=6 genes, K=2: restarts of 3 and 5 sweeps
    (flops, nbytes, special), = frob.work(10, 6, 0, 0, {2: [3, 5]})
    sweeps = 8
    assert flops == sweeps * (4 * 10 * 6 * 2 + 4 * 16 * 4)   # 480 + 256
    assert special == sweeps * 16 * 2
    assert nbytes == sweeps * 8 * 16 * 2 + 5 * 8 * 10 * 6


def test_kl_work_by_hand():
    kl = cells.load_module("work", "kullback-leibler")
    # N=10, G=6, K=2, 7 nonzeros, 5 entries above eps; restarts of 10 and
    # 20 iterations: 30 iterations, 2 + 3 = 5 checks (the one at the start
    # included)
    (flops, nbytes, special), = kl.work(10, 6, 7, 5, {2: [10, 20]})
    assert flops == 30 * (8 * 2 * 7 + 16 * 2) + 5 * 5 * 5
    assert special == 30 * (2 * 7 + 16 * 2) + 5 * 5
    assert nbytes == 30 * 8 * 16 * 2 + (2 * 20 + 2 + 1) * 4 * 10 * 6


@pytest.mark.parametrize("work, expect", [
    ((67e12, 0, 0), 1.0),              # bound by operations
    ((0, 3.35e12, 0), 1.0),            # by bytes
    ((0, 0, 132 * 16 * 1980e6), 1.0),  # by special-function lanes
    ((67e12, 6.7e12, 0), 2.0),
])
def test_least_seconds_takes_the_slowest(work, expect):
    pk = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert peaks.least_seconds([work], pk) == pytest.approx(expect)


def test_unknown_card_has_no_peaks():
    assert peaks.peaks("cpu") is None
