"""kernels.factorize_roofline_pct: the least time in which the card could
do the factorize's needed work, over the device time inside the traced
job's factorize span.

The needed work is counted from the inputs alone, by the loss's work model
(``work/<beta_loss>.py``): N, G, each K, every restart's own n_iter, X's
nonzeros and entries above float32's eps. The least time takes the card's
published peaks (``benchkit.peaks``). The device time is the union of every
device operation's interval that the timeline places inside the span,
whatever kernel ran: no kernel name and no counter of the program is read.
Where the card is not in the peak table, or nothing ran, nothing is
reported."""

from benchkit import cells, peaks, trace


def read(run):
    pk = peaks.peaks(run.kind)
    if run.trace is None or pk is None or run.shape is None:
        return None
    spans = [s for s in run.trace["spans"] if s[0] == "factorize"]
    if not spans:
        return None
    _, lo, hi = spans[0]
    busy = trace.covered(trace.union(run.trace["ops"]), lo, hi)
    if busy <= 0:
        return None
    job = run.traced
    model = cells.load_module("work", run.cell["beta_loss"])
    N, G = run.shape
    least = peaks.least_seconds(
        model.work(N, G, run.nnz, run.n_gt_eps, job.n_iter), pk)
    return 100.0 * least / busy
