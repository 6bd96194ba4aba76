"""Span tracing with Chrome trace-event export (port of
`liquid_tpu/utils/tracing.py`, without the W3C propagation the server
uses).

A process-wide recorder of context-manager / decorator spans on a
thread-local stack; disabled (one attribute check per span) until
`TRACER.enable()`.  `export_chrome_trace` writes JSON that Perfetto and
chrome://tracing load.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Span:
    __slots__ = ("name", "parent", "start", "end", "attrs", "tid")

    def __init__(self, name, parent, start, tid):
        self.name = name
        self.parent = parent
        self.start = start
        self.end = None
        self.attrs: Dict[str, object] = {}
        self.tid = tid


class Tracer:
    def __init__(self):
        self.enabled = False
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans = []

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        s = Span(name, stack[-1].name if stack else None,
                 time.perf_counter_ns(), threading.get_ident())
        s.attrs.update(attrs)
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter_ns()
            stack.pop()
            with self._lock:
                self._spans.append(s)

    def trace(self, name: Optional[str] = None):
        """Decorator form of `span`."""
        def deco(fn):
            nm = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"

            def wrapper(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with self.span(nm):
                    return fn(*a, **kw)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def export_chrome_trace(self, path: str) -> int:
        events = []
        with self._lock:
            for s in self._spans:
                events.append({
                    "name": s.name, "ph": "X", "pid": os.getpid(),
                    "tid": s.tid, "ts": s.start / 1000,
                    "dur": ((s.end or s.start) - s.start) / 1000,
                    "args": {**s.attrs, "parent": s.parent}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return len(events)


#: process-global tracer
TRACER = Tracer()
