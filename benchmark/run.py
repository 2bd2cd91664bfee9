"""Run one cell of the benchmark once on the card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 benchmark/run.py --list

A run draws the configuration's counts from its data seed (one fixed data
set) and warms the program up on one short job (set-up). Then it runs whole
cNMF jobs back to back, a closed loop, from the window's start until the
first job that ends after ``--seconds``; each job gets its own restart
seeds (from the run's seed and its index) and its own copy of the counts. With ``--trace 1`` one more job
runs after the window under ``torch.profiler``. Then one job of the window,
drawn from the seed, is checked against the plain reference
(``benchkit.check``).

The last line of standard output is one JSON object: whether the run is
correct, the jobs attempted and failed, the cell's end-to-end metrics
(``--trace 0``) or per-layer metrics (``--trace 1``), the device, and last
the compared numbers beside their limits, which are also the last lines of
standard error.

Exit codes: 0 after a result; 2 without a CUDA card (or with fewer than
the cell asks for); 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time


def _process_age() -> float:
    """Seconds since this process started (Linux's /proc; 0 elsewhere)."""
    try:
        import os

        with open("/proc/self/stat") as fh:
            start = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "cnmf_tpu")
WARM_JOB = 10 ** 6   # the set-up job's index: its seeds are no window job's


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print the cells, configurations, metrics and work "
                         "models the folder holds")
    return ap.parse_args(argv)


class Run:
    """What the metric readers read."""

    def __init__(self, cell, seed, kind):
        self.cell, self.seed, self.kind = cell, seed, kind
        self.setup_s = self.window_s = None
        self.jobs = []          # the window's job outputs
        self.spans = []         # (job, span, start, end), host clock
        self.trace = None       # benchkit.trace.read of the traced job
        self.traced = None      # the traced job's output
        self.peak_bytes = 0
        self.shape, self.nnz, self.n_gt_eps = None, 0, 0

    def span_seconds(self, name: str):
        """Mean seconds of a span a job over the window's jobs."""
        rows = [e - s for j, n, s, e in self.spans
                if n == name and j < len(self.jobs)]
        return sum(rows) / len(rows) if rows else None

    def trace_window(self):
        from benchkit import trace
        return trace.window(self.trace) if self.trace else None


def jobs_for(run, cell, counts, device, seconds, spans, first=0):
    """Jobs back to back until one ends after ``seconds`` (one job at
    least); returns (outputs, failed jobs)."""
    from benchkit.job import job_seed, run_job

    outs, t0 = [], time.perf_counter()
    while True:
        j = first + len(outs)
        try:
            outs.append(run_job(cell, counts, job_seed(run.seed, j), device,
                                spans, j))
        except Exception as exc:  # a failed job ends the loop
            print(f"[job {j}] failed: {exc!r}", file=sys.stderr)
            return outs, 1
        if time.perf_counter() - t0 >= seconds:
            return outs, 0


def traced_job(run, cell, counts, device, spans, on_card):
    """One more job under ``torch.profiler`` (CPU ops and annotations,
    and the card's operations)."""
    from torch.profiler import ProfilerActivity, profile

    from benchkit import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        outs, failed = jobs_for(run, cell, counts, device, 0.0, spans,
                                first=len(run.jobs))
    run.trace = trace.read(prof)
    run.traced = outs[0] if outs else None
    return failed


def check_one(run, cell, counts, outs, device, seed):
    """The compared numbers of one job of the window drawn from the seed,
    and the input sizes the work models read."""
    import numpy as np
    import scipy.sparse as sp

    from benchkit import check

    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    pick = outs[int(rng.integers(len(outs)))]
    norm = pick.norm
    vals = norm.data if sp.issparse(norm) else np.asarray(norm)
    run.shape = norm.shape
    run.nnz = int(np.count_nonzero(vals))
    run.n_gt_eps = int((vals.astype(np.float32)
                        > np.finfo(np.float32).eps).sum())
    sample = check.sample_restarts(cell, rng)
    seeds = check.restart_seeds(cell["components"], int(cell["n_iter"]),
                                pick.seed)
    side = check.program_outputs(pick, sample)
    return check.compare(cell, counts, side, pick.spectra, seeds, sample,
                         device)


def main(argv=None, device=None, cell=None):
    args = parse(argv)
    from benchkit import cells

    if args.list:
        print(json.dumps(cells.listing()))
        return 0
    import torch

    bench = cells.benchmark()
    cell = cell or cells.cell(args.workload)
    entry = next((w for w in bench["workloads"] if w["name"] == cell["name"]),
                 {"chips": 1})
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(entry["chips"])):
            print("no CUDA card, or fewer than the cell asks for: no result",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    from benchkit import check, generate, peaks
    from benchkit.job import Spans
    from cnmf_tpu_torch import native
    from cnmf_tpu_torch.ops import kernel_lib

    # set-up: the program's libraries, the counts, one short job; the
    # seconds since the process began at the end of each part
    run = Run(cell, args.seed,
              torch.cuda.get_device_name(device) if on_card else "cpu")
    marks = {"imports": time.perf_counter() - T_START}
    native.library_loaded()
    if on_card:
        kernel_lib.load_library()
    marks["libraries"] = time.perf_counter() - T_START
    counts = generate.counts_for(cell["cfg"], cell["cfg"]["data_seed"],
                                 device)
    marks["counts"] = time.perf_counter() - T_START
    # a short solve of every K; its few iterations leave noisy spectra, so
    # its consensus keeps them all (density threshold 2: no two unit
    # vectors lie further apart)
    warm = dict(cell, max_iter=int(cell["check"]["warm_iter"]),
                density_threshold=2.0)
    _, failed = jobs_for(run, warm, counts, device, 0.0, Spans(device),
                         first=WARM_JOB)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - T_START

    spans = Spans(device)
    t0 = time.perf_counter()
    if not failed:
        run.jobs, failed = jobs_for(run, cell, counts, device, args.seconds,
                                    spans)
    run.window_s = time.perf_counter() - t0
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    if on_card:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if args.trace and not failed:
        failed += traced_job(run, cell, counts, device, spans, on_card)
    run.spans = spans.rows
    torch.cuda.empty_cache() if on_card else None

    nums = (check_one(run, cell, counts, run.jobs, device, args.seed)
            if run.jobs else {})
    checks, ok = check.verdict(nums, cell["limits"])

    metrics = {}
    for m in cells.metrics_for(bench, cell["name"], bool(args.trace)):
        value = cells.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": run.kind,
           "count": 1 if on_card else 0, "memory_peak_bytes": run.peak_bytes}
    attempted = len(run.jobs) + (run.traced is not None) + failed
    result = {"correct": bool(ok and not failed), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    span = run.trace_window()
    if args.trace and span is not None:
        from benchkit import trace

        dev.update(busy_s=trace.busy(run.trace, *span),
                   window_s=span[1] - span[0])
        result["breakdown"] = trace.breakdown(run.trace, *span)
    # each window job's spans and sweeps, for a reader of the line
    result["jobs"] = [
        {"sweeps": int(sum(int(n.sum()) for n in job.n_iter.values())),
         **{n: e - s for j, n, s, e in run.spans if j == i}}
        for i, job in enumerate(run.jobs)]
    result["setup"] = dict(marks, warm_job=run.setup_s)
    result["checks"] = checks
    print(f"card: {peaks.power_limit() if on_card else 'cpu'}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
