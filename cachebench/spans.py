"""Reductions over the program's own spans inside `sql.execute`, for the
per-layer readers of `fused.*`, `agg.*` and `wait.*` (the span names are
the program's, `liquid_tpu_torch/utils/tracing.py` and its callers), and
the check that the program's `wait.*` spans hold the blocking CUDA
runtime calls the profiler records.

A program that records none of these spans (one older than them) makes
the readers return None, so a result line leaves their metrics out; a
program that records some of them reads 0.0 where a layer did no work in
the window.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from cachebench.trace import SpanRec, union

#: the prefixes of the program's layer spans under `sql.execute`
LAYERS = ("exec.", "agg.", "fused.", "wait.")


def layer_spans_recorded(run) -> bool:
    """The run holds `sql.execute` spans, completed queries and at least
    one span of the program's layers."""
    return bool(run.completed) and any(
        s.name == "sql.execute" for s in run.spans) and any(
        s.name.startswith(LAYERS) for s in run.spans)


def is_wait(s: SpanRec) -> bool:
    return s.name.startswith("wait.")


def outermost(spans: List[SpanRec], match: Callable[[SpanRec], bool]
              ) -> Dict[str, SpanRec]:
    """{span id: span} of the matching spans that no matching span holds
    (by the parent ids)."""
    byid = {s.span_id: s for s in spans}

    def held(s):
        p = byid.get(s.parent_id)
        while p is not None:
            if match(p):
                return True
            p = byid.get(p.parent_id)
        return False
    return {s.span_id: s for s in spans if match(s) and not held(s)}


def owner_of(s: SpanRec, tops: Dict[str, SpanRec],
             byid: Dict[str, SpanRec]) -> Optional[SpanRec]:
    """The span of `tops` that holds `s`, if any."""
    p = byid.get(s.parent_id)
    while p is not None:
        if p.span_id in tops:
            return p
        p = byid.get(p.parent_id)
    return None


def host_ns_less_waits(spans: List[SpanRec],
                       match: Callable[[SpanRec], bool]) -> int:
    """The summed length of the outermost matching spans, less the union
    of the `wait.*` spans each holds."""
    tops = outermost(spans, match)
    byid = {s.span_id: s for s in spans}
    waits = defaultdict(list)
    for s in spans:
        if is_wait(s):
            top = owner_of(s, tops, byid)
            if top is not None:
                waits[top.span_id].append((s.start, s.end))
    return sum((t.end - t.start)
               - sum(e - b for b, e in union(waits[t.span_id]))
               for t in tops.values())


def per_query_ms(run, match: Callable[[SpanRec], bool]) -> Optional[float]:
    """`host_ns_less_waits` in ms over the queries completed, or None for
    a run without the program's layer spans."""
    if not layer_spans_recorded(run):
        return None
    return host_ns_less_waits(run.spans, match) / 1e6 / run.completed


def wait_offsets(spans: List[SpanRec], calls: List[Tuple[int, int]]
                 ) -> List[Tuple[int, int, int]]:
    """For each `wait.*` span that overlaps a blocking runtime call: (its
    start, the ns from its start to the first call's start, the ns from
    the last call's end to its end).  Both offsets are >= 0 where the
    span holds its calls; a negative one is how far a call sticks out."""
    calls = sorted(calls)
    starts = [b for b, _e in calls]
    out = []
    for s in sorted((s for s in spans if is_wait(s)), key=lambda s: s.start):
        # the host makes one runtime call at a time: at most the call
        # before the span's start can reach into it
        lo = max(bisect_left(starts, s.start) - 1, 0)
        hit = [c for c in calls[lo:bisect_left(starts, s.end)]
               if c[1] > s.start]
        if hit:
            out.append((s.start, hit[0][0] - s.start,
                        s.end - max(e for _b, e in hit)))
    return out


def wait_coverage(spans: List[SpanRec], calls: List[Tuple[int, int]]
                  ) -> Tuple[int, int]:
    """(ns of blocking runtime calls inside `sql.execute` spans, ns of
    those inside `wait.*` spans)."""
    execs = union((s.start, s.end) for s in spans if s.name == "sql.execute")
    waits = union((s.start, s.end) for s in spans if is_wait(s))
    inside = _intersect(union(calls), execs)
    return (sum(e - b for b, e in inside),
            sum(e - b for b, e in _intersect(inside, waits)))


def _intersect(a: List[Tuple[int, int]], b: List[Tuple[int, int]]
               ) -> List[Tuple[int, int]]:
    """The intersection of two sorted unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out
