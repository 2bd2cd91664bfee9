"""device.idle_pct: the share of the traced job's window (its first span's
start to its last span's end on the profiler's timeline) that no device
operation covers: the union of the operations' intervals, not their sum,
so that overlapping streams count once."""

from benchkit import trace


def read(run):
    span = run.trace_window()
    if span is None:
        return None
    return 100.0 * (1.0 - trace.busy(run.trace, *span) / (span[1] - span[0]))
