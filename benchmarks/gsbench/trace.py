"""What a traced run reads from torch.profiler: the device's intervals and
the named host ranges, and the arithmetic on them.

The trace stays in memory and is reduced to two lists:

- device intervals (name, stream, start_ns, end_ns): every kernel, copy and
  memset on the card, user annotations left out;
- ranges (name, start_ns, end_ns): the record_function ranges of the host,
  the program's phases (gs2pc_torch.utils.log.phase) and the benchmark's
  own spans around the window and each conversion.

Busy time is the union of the device intervals, whatever stream they ran
on: since the uploads and the point fetch run on side streams, intervals
overlap, and a sum would count the overlap twice (summed_seconds is that
sum, kept to show the difference).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, NamedTuple, Optional


class Interval(NamedTuple):
    name: str
    stream: int
    start_ns: int
    end_ns: int


class Range(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: list  # [Interval], sorted by start
    ranges: list  # [Range]

    def spans(self, name: str) -> list:
        """The ranges called ``name``, in order."""
        return sorted((r for r in self.ranges if r.name == name), key=lambda r: r.start_ns)


def from_profiler(prof) -> Trace:
    """The device intervals and host ranges of a finished
    torch.profiler.profile, read from its raw events."""
    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        start, end = int(e.start_ns()), int(e.end_ns())
        if end <= start:
            continue
        if kind.endswith("CUDA"):
            if not e.is_user_annotation():
                device.append(Interval(e.name(), int(e.device_resource_id()), start, end))
        elif e.is_user_annotation():
            ranges.append(Range(e.name(), start, end))
    device.sort(key=lambda i: i.start_ns)
    return Trace(device, ranges)


def merged(intervals: Iterable, lo: int, hi: int) -> list:
    """The union of ``intervals`` (anything with start_ns / end_ns) clipped
    to [lo, hi), as sorted disjoint (start, end) pairs."""
    out = []
    for iv in sorted(intervals, key=lambda i: i.start_ns):
        s, e = max(iv.start_ns, lo), min(iv.end_ns, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: Iterable, lo: int, hi: int) -> float:
    """Seconds in [lo, hi) in which at least one interval runs."""
    return sum(e - s for s, e in merged(intervals, lo, hi)) / 1e9


def summed_seconds(intervals: Iterable) -> float:
    """The plain sum of the intervals' durations (overlaps counted twice)."""
    return sum(i.end_ns - i.start_ns for i in intervals) / 1e9


def busy_within(intervals: list, spans: list) -> tuple:
    """(busy seconds, wall seconds) of the device inside ``spans``: per span
    the union of the intervals clipped to it, summed over the spans."""
    busy = sum(union_seconds(intervals, s.start_ns, s.end_ns) for s in spans)
    wall = sum(s.end_ns - s.start_ns for s in spans) / 1e9
    return busy, wall


def device_seconds(intervals: list, match, lo: int, hi: int) -> float:
    """Summed device seconds in [lo, hi) of the intervals whose name
    ``match`` accepts (one kernel does not overlap itself)."""
    return sum(min(i.end_ns, hi) - max(i.start_ns, lo) for i in intervals
               if match(i.name) and i.end_ns > lo and i.start_ns < hi) / 1e9


def top_ops(intervals: list, lo: int, hi: int, n: int = 10) -> list:
    """The ``n`` device operations that took the most device time in
    [lo, hi), as [name, seconds]."""
    by = defaultdict(int)
    for i in intervals:
        d = min(i.end_ns, hi) - max(i.start_ns, lo)
        if d > 0:
            by[i.name[:120]] += d
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def enclosing(ranges: list, t: int, skip: tuple = ()) -> Optional[str]:
    """The innermost (shortest) range that holds time ``t``, among ranges
    whose name is not in ``skip``."""
    best = None
    for r in ranges:
        if r.start_ns <= t < r.end_ns and r.name not in skip:
            if best is None or r.end_ns - r.start_ns < best.end_ns - best.start_ns:
                best = r
    return None if best is None else best.name


def idle_gaps(intervals: list, ranges: list, lo: int, hi: int, n: int = 10,
              skip: tuple = ()) -> list:
    """The ``n`` longest stretches of [lo, hi) in which nothing ran on the
    device, each named by the innermost host range around its middle (what
    the host was doing), as [name, seconds]."""
    busy = merged(intervals, lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        name = enclosing(ranges, (s + e) // 2, skip) or "between conversions"
        out.append([name, (e - s) / 1e9])
    return out
