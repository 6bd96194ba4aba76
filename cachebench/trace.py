"""What a `--trace 1` run records over its window, and the reductions the
harness makes of it.

- Device operations (kernels, copies, sets) from `torch.profiler`'s CUDA
  activity, each as (name, start ns, end ns) on the host's
  `perf_counter_ns` clock.
- The host's waits for the card, from the same activity: the CUDA runtime
  calls that block the host until the card or its copy engine is done
  (`blocking`), as (start ns, end ns).
- The program's `TRACER` spans (`liquid_tpu_torch.utils.tracing`).
- Calls that per-layer metrics hook (a metric's `HOOKS`): the arguments'
  shapes, recorded by a wrapper put around a module function for the
  window.

The busy time is the union of the device operations' intervals (the
arithmetic of `chip_smoke.py::device_breakdown`), and each idle gap is
labelled by the innermost span open on the host at its middle.
"""
from __future__ import annotations

import importlib
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple


@dataclass
class SpanRec:
    name: str
    start: int
    end: int
    span_id: str
    parent_id: str


def union(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Hooks:
    """Wrappers that record a call's shapes, put around module functions
    for the window: `hooks[(module, function)] = record(args, kwargs)`."""

    def __init__(self, hooks: Dict[Tuple[str, str], Callable]):
        self.hooks = hooks
        self.calls: Dict[Tuple[str, str], list] = defaultdict(list)
        self._saved = []

    def __enter__(self):
        for (mod_name, fn_name), record in self.hooks.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            calls = self.calls[(mod_name, fn_name)]

            def wrapper(*a, _fn=fn, _rec=record, _calls=calls, **kw):
                _calls.append(_rec(a, kw))
                return _fn(*a, **kw)
            self._saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in reversed(self._saved):
            setattr(mod, fn_name, fn)
        self._saved = []
        return False


def blocking(name: str) -> bool:
    """A CUDA runtime call that blocks the host until the card or its copy
    engine is done: a synchronize, or a copy (one to pageable host memory
    returns only when it has landed)."""
    return name.startswith("cudaMemcpy") or "Synchronize" in name


class DeviceTrace:
    """torch.profiler's CUDA activity over a `with` block."""

    def __init__(self, torch):
        self.torch = torch
        self.events: List[Tuple[str, int, int]] = []
        self.waits: List[Tuple[int, int]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._wall_minus_perf = time.time_ns() - time.perf_counter_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if not e.is_hidden_event()]
        raw = [(e.name(), e.start_ns(), e.end_ns()) for e in events
               if e.device_type() == DeviceType.CUDA]
        waits = [(e.name(), e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() != DeviceType.CUDA
                 and blocking(e.name())]
        shift = _clock_shift(raw + waits, self._wall_minus_perf,
                             self._t0, t1)
        self.events = [(n, s - shift, e - shift) for n, s, e in raw]
        self.waits = [(s - shift, e - shift) for _n, s, e in waits]
        return False


def _clock_shift(raw, wall_minus_perf: int, t0: int, t1: int) -> int:
    """The profiler stamps events on the wall clock or on the monotonic
    one, by build; the shift that puts them inside the block."""
    if not raw:
        return 0
    mid = sorted(s for _n, s, _e in raw)[len(raw) // 2]
    return wall_minus_perf if not (t0 <= mid <= t1) else 0


def spans_of(tracer) -> List[SpanRec]:
    return [SpanRec(s.name, s.start, s.end, s.span_id, s.parent_id or "")
            for s in tracer.spans() if s.end is not None]


def clip_events(events, lo: int, hi: int):
    """The events that overlap [lo, hi], cut to it."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if e > lo and s < hi]


def busy(events, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The device's busy intervals inside [lo, hi]."""
    return union((s, e) for _n, s, e in clip_events(events, lo, hi))


def top_ops(events, k: int = 10) -> List[list]:
    """The device operations that took most time: [[name, seconds]]."""
    by = defaultdict(int)
    for n, s, e in events:
        by[n] += e - s
    return [[n[:160], ns / 1e9] for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(busy_iv, spans: List[SpanRec], lo: int, hi: int,
              k: int = 10) -> List[list]:
    """Idle device time inside [lo, hi] by what the host was doing: each
    gap labelled by the innermost span open at its middle ("harness" where
    none is), summed per label: [[label, seconds]]."""
    gaps, t = [], lo
    for s, e in busy_iv:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    # a sweep: span starts push, ends pop, gap middles read the top
    marks = []
    for i, sp in enumerate(spans):
        marks.append((sp.start, 0, i))
        marks.append((sp.end, 2, i))
    for j, (s, e) in enumerate(gaps):
        marks.append(((s + e) // 2, 1, j))
    marks.sort()
    open_, by = [], defaultdict(int)
    for _t, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            s, e = gaps[i]
            by[spans[open_[-1]].name if open_ else "harness"] += e - s
    return [[n, ns / 1e9] for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:k]]
