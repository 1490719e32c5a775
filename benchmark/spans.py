"""The program's spans (pathtrace_tpu_torch/utils/profiling.py) against
rank 0's device trace (benchmark/trace.py), for the per-layer metrics that
read them.

The program stamps its spans with time.time_ns(), the profiler's own clock,
but the DeviceTrace keeps device times from its first operation, so the
origin is recovered from what both sides record once each: every launch of
the program's kernels B1, B2 and B3. The k-th b1.launch / b2.launch /
b3.launch span pairs with the k-th pt::bounce_kernel / pt::kd_walk_kernel /
pt::mt_closest_kernel operation in start order. A kernel cannot start
before the host has called its launch, so every pair bounds the offset
from below, and the largest bound is within the launch latency wherever a
launch found the device idle. Idle time is counted from the first root
span's start to the last root span's end on that clock: the device trace's
own window starts on the host before the first launch, and its zero is the
first operation.

What is read here includes the profiler's own host cost: every eager
launch takes longer under it, so the spans are longer and the device idles
more than in an untraced run. On an H100 host the traced slice runs 1.0-1.1x
its untraced wall on cornell.image256, 1.15-1.2x on cornell.train128 and
1.5-1.8x on blob82k.image256 (`breakdown.windows` of a traced run).

Every function returns None, and raises nothing, when the program has no
recorder or recorded nothing (a program older than its spans), when the
run has no device trace, or when the launches do not pair.
"""

from __future__ import annotations

import dataclasses
import heapq

# (span, kernel) pairs that anchor the host clock to the device's
ANCHORS = (("b1.launch", "pt::bounce_kernel"), ("b2.launch", "pt::kd_walk_kernel"),
           ("b3.launch", "pt::mt_closest_kernel"))
# where idle time goes that no span of the program covers
OUTSIDE = "outside the program"


def program_records():
    """The program's span records, in the order they opened (indices are
    positions in this list), or None where it has no recorder or none."""
    try:
        from pathtrace_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    recs = read()
    return recs or None


def within(recs: list, i: int, name: str) -> bool:
    """Whether span i, or one of the spans it nests in, is named `name`."""
    while i >= 0:
        if recs[i].name == name:
            return True
        i = recs[i].parent
    return False


@dataclasses.dataclass
class Aligned:
    records: list   # the program's spans (program_records())
    start_us: list  # each span's start, microseconds on the trace's clock (None while open)
    end_us: list
    events: list    # rank 0's device operations (name, start_us, end_us), in start order
    window_us: tuple  # (first root span's start, last root span's end), on the trace's clock
    offset_us: float  # host time (us from the first span's start) of the trace's zero


def aligned(rec):
    """Rank 0's spans on the clock of rank 0's device trace (Aligned), or
    None when there are no records or trace, no launch to pair, no root
    span closed, or the launches and the kernels they launched differ in
    number."""
    recs = program_records()
    if recs is None or not getattr(rec, "traces", None):
        return None
    trace = rec.traces[0]
    origin = recs[0].start_ns
    host_us = lambda ns: (ns - origin) / 1e3
    bounds = []
    for span_name, kernel in ANCHORS:
        starts = sorted(host_us(s.start_ns) for s in recs if s.name == span_name)
        ops = [s for n, s, _ in trace.events if kernel in n]
        if len(starts) != len(ops):
            return None
        bounds += [h - d for h, d in zip(starts, ops)]
    if not bounds:
        return None
    offset = max(bounds)
    start = [host_us(s.start_ns) - offset for s in recs]
    end = [None if s.end_ns is None else host_us(s.end_ns) - offset for s in recs]
    roots = [i for i, s in enumerate(recs) if s.parent < 0 and end[i] is not None]
    if not roots:
        return None
    window = (min(start[i] for i in roots), max(end[i] for i in roots))
    return Aligned(recs, start, end, trace.events, window, offset)


def _idle_intervals(events, lo: float, hi: float) -> list:
    """The device's idle intervals (start, end) within [lo, hi]: the
    complement there of the union of the operations (in start order)."""
    out, cur = [], lo
    for _, s, e in events:
        if s >= hi:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def _innermost(al: Aligned) -> list:
    """The spans' time cut at their boundaries into (start, end, index)
    pieces, each labelled with the innermost span open then (the one opened
    last), index None where none is open."""
    closed = [i for i, e in enumerate(al.end_us) if e is not None and e > al.start_us[i]]
    marks = sorted({t for i in closed for t in (al.start_us[i], al.end_us[i])})
    by_start = sorted(closed, key=lambda i: (al.start_us[i], i))
    heap, pieces, k = [], [], 0
    for t0, t1 in zip(marks, marks[1:]):
        while k < len(by_start) and al.start_us[by_start[k]] <= t0:
            i = by_start[k]
            heapq.heappush(heap, (-al.start_us[i], -i, al.end_us[i]))
            k += 1
        while heap and heap[0][2] <= t0:
            heapq.heappop(heap)
        pieces.append((t0, t1, -heap[0][1] if heap else None))
    return pieces


def idle_by_span(rec):
    """Rank 0's idle device time, microseconds, by the span it is put down
    to: {span index: us, OUTSIDE: us}. Each idle interval is split at span
    boundaries and each piece goes to the innermost span open on the host
    then, or to OUTSIDE where none is. None as aligned()."""
    al = aligned(rec)
    return None if al is None else _attribute(al)


def idle_ms_per(rec, under: str, per: str):
    """Rank 0's idle milliseconds put down to spans named `under` or to
    spans inside them, over the number of spans named `per`; None as
    aligned(), or where no span is named `per`."""
    al = aligned(rec)
    if al is None:
        return None
    units = sum(1 for s in al.records if s.name == per)
    if not units:
        return None
    us = sum(v for i, v in _attribute(al).items()
             if i != OUTSIDE and within(al.records, i, under))
    return us / 1e3 / units


def _attribute(al: Aligned) -> dict:
    pieces = _innermost(al)
    out, k = {OUTSIDE: 0.0}, 0
    for s, e in _idle_intervals(al.events, *al.window_us):
        while k < len(pieces) and pieces[k][1] <= s:
            k += 1
        t, j = s, k
        while t < e:
            if j < len(pieces) and pieces[j][0] <= t:
                p0, p1, idx = pieces[j]
                stop = min(e, p1)
                key = OUTSIDE if idx is None else idx
                j += 1
            else:  # before the next piece, or past the last: no span open
                p0 = pieces[j][0] if j < len(pieces) else e
                stop, key = min(e, p0), OUTSIDE
            out[key] = out.get(key, 0.0) + stop - t
            t = stop
    return out


def ops_in(rec, name: str):
    """The number of rank 0's device operations that start inside spans
    named `name`, on the aligned clock; None as aligned()."""
    al = aligned(rec)
    if al is None:
        return None
    spans = sorted((al.start_us[i], al.end_us[i]) for i, s in enumerate(al.records)
                   if s.name == name and al.end_us[i] is not None)
    n, k = 0, 0
    for _, s, _ in al.events:
        while k < len(spans) and spans[k][1] < s:
            k += 1
        # spans of one name do not nest: the next one ending at or after s
        # holds s if it has started by then
        if k < len(spans) and spans[k][0] <= s:
            n += 1
    return n
