"""The traced run's events, and the arithmetic the per-layer readers share.

``from_profiler`` turns ``torch.profiler``'s raw events into plain lists:
the device operations (kernels, copies, sets) with the host time of the
call that launched each, the ``record_function`` ranges, and the host
operations. Everything below works on those lists alone, so it is tested
on synthetic ones.

Times are microseconds on the profiler's clock. The device busy time is
the union of the device operations' intervals inside the window, as
``profile_step.py`` takes it (one stream, so the operations do not
overlap). Operations launched under a ``bench.*`` range other than the
window itself are the benchmark's own (copies kept for the check,
samples of the K4 inputs) and are left out of every reading.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

WINDOW_RANGE = "bench.window"


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    kind: str  # "kernel", "memcpy" or "memset"
    launch: float | None  # host time of the launching call


@dataclass
class TraceData:
    window: tuple  # (start, end) of the WINDOW_RANGE
    device: list = field(default_factory=list)  # DeviceOp, in start order
    ranges: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end) host operations


def kind_of(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_profiler(prof) -> TraceData:
    """The plain lists of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    launches, device, ranges, host, window = {}, [], [], [], None
    annotations = set()
    for e in events:
        if e.device_type().name == "CPU":
            name, t0 = e.name(), e.start_ns() / 1e3
            t1 = t0 + e.duration_ns() / 1e3
            if e.is_user_annotation():
                annotations.add(name)
                ranges.append((name, t0, t1))
                if name == WINDOW_RANGE:
                    window = (t0, t1)
            elif name.startswith(("cuda", "cu")) and "Launch" in name or name.startswith(
                    ("cudaMemcpy", "cudaMemset")):
                launches[e.correlation_id()] = t0
            else:
                host.append((name, t0, t1))
    for e in events:
        if e.device_type().name == "CPU" or e.is_user_annotation() or e.name() in annotations:
            continue
        t0 = e.start_ns() / 1e3
        launch = launches.get(e.linked_correlation_id(), launches.get(e.correlation_id()))
        device.append(DeviceOp(e.name(), t0, t0 + e.duration_ns() / 1e3, kind_of(e.name()),
                               launch))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_RANGE} range")
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o[1])
    return TraceData(window=window, device=device, ranges=ranges, host=host)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Spans:
    """The union of some intervals, for ``t in spans``."""

    def __init__(self, intervals):
        u = _union(intervals)
        self.starts = [a for a, _ in u]
        self.ends = [b for _, b in u]

    def __contains__(self, t):
        if t is None:
            return False
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def program_ops(data: TraceData) -> list:
    """The device operations inside the window that the program launched
    (not under a ``bench.*`` range of the benchmark's own)."""
    own = Spans([(a, b) for n, a, b in data.ranges
                 if n.startswith("bench.") and n != WINDOW_RANGE])
    w0, w1 = data.window
    return [o for o in data.device if o.end > w0 and o.start < w1 and o.launch not in own]


def busy_us(ops, window) -> float:
    """The time some operation of ``ops`` ran, inside ``window``."""
    w0, w1 = window
    return sum(b - a for a, b in _union((max(o.start, w0), min(o.end, w1)) for o in ops
                                        if o.end > w0 and o.start < w1))


def under(ops, data: TraceData, range_name: str) -> list:
    """The operations of ``ops`` launched inside a range ``range_name``."""
    spans = Spans([(a, b) for n, a, b in data.ranges if n == range_name])
    return [o for o in ops if o.launch in spans]


NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this many characters


def top_ops(ops, n=10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time, summed by name (cut to ``NAME_CHARS``)."""
    total = {}
    for o in ops:
        key = o.name[:NAME_CHARS]
        total[key] = total.get(key, 0.0) + (o.end - o.start)
    return [[k, v / 1e6] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(host, starts, t) -> str:
    """The innermost host operation running at ``t``."""
    if t is None:
        return "host"
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - 64, -1), -1):
        name, a, b = host[k]
        if a <= t <= b:
            return name
    return "host"


def idle_gaps(ops, data: TraceData, n=10) -> list:
    """``[[name, seconds], ...]``: the device's idle time inside the window,
    summed by what the host was doing when the gap ended (the host
    operation that launched the next device operation), longest first."""
    w0, w1 = data.window
    starts = [h[1] for h in data.host]
    total, t = {}, w0
    for o in sorted(ops, key=lambda o: o.start):
        if o.start > t:
            key = _host_at(data.host, starts, o.launch)
            total[key] = total.get(key, 0.0) + (min(o.start, w1) - t)
        t = max(t, o.end)
    if w1 > t:
        total["window end"] = total.get("window end", 0.0) + (w1 - t)
    return [[k, v / 1e6] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
