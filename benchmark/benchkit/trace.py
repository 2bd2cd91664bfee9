"""What a traced run reads from ``torch.profiler``'s timeline: every device
operation's interval (kernels, copies, fills), their union, and the
harness's spans (``bench:<name>`` annotations), all in seconds on the
profiler's clock. The raw events are read as the profiler recorded them,
without building its tree of function events."""

from __future__ import annotations

from collections import defaultdict


def read(prof) -> dict:
    """{"ops": [(start, end, name)] device operations, "spans": [(name,
    start, end)] harness annotations}, sorted by start."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in getattr(prof, "profiler", prof).kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        if name.startswith("bench:"):
            if e.device_type() != DeviceType.CUDA:
                spans.append((name[len("bench:"):], start, end))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((start, end, name))
    ops.sort()
    spans.sort(key=lambda s: s[1])
    return {"ops": ops, "spans": spans}


def union(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted [start, end]."""
    merged = []
    for start, end, *_ in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def covered(merged, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged, lo: float, hi: float) -> list:
    """The idle stretches (start, end) of [lo, hi] between the merged
    intervals."""
    out, at = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def window(tr: dict):
    """(start, end) of the traced job: its first span's start to its last
    span's end; None without spans."""
    if not tr["spans"]:
        return None
    return tr["spans"][0][1], max(e for _, _, e in tr["spans"])


def span_at(spans, t: float) -> str:
    for name, s, e in spans:
        if s <= t <= e:
            return name
    return "between spans"


def busy(tr: dict, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which some device operation ran."""
    return covered(union(tr["ops"]), lo, hi)


def breakdown(tr: dict, lo: float, hi: float, n: int = 10) -> dict:
    """The device operations that took most time inside [lo, hi], and the
    longest idle gaps there, each named by the span open at its middle."""
    by_name = defaultdict(float)
    for s, e, name in tr["ops"]:
        if s >= lo and e <= hi:
            by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(gaps(union(tr["ops"]), lo, hi), key=lambda g: g[0] - g[1])
    return {"device_ops": [[name[:120], sec] for name, sec in ops],
            "idle_gaps": [[span_at(tr["spans"], (s + e) / 2), e - s]
                          for s, e in idle[:n]]}
