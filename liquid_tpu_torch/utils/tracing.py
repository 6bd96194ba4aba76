"""Span tracing, W3C trace propagation and Chrome trace-event export (port
of `liquid_tpu/utils/tracing.py`).

A process-wide recorder of context-manager / decorator spans on a
thread-local stack; disabled (one attribute check per span) until
`TRACER.enable()`.  Each span carries a trace id, its own span id and
its parent's (`parent` keeps the parent span's name).  Across the
client / server boundary a span travels as a W3C `traceparent` string
in the Flight ticket (`current_traceparent` on the client,
`remote_span` on the server; reference `:106-146`).
`export_chrome_trace` writes JSON that Perfetto and chrome://tracing
load; `export_otlp` keeps the reference's contract (`:170-177`).
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Dict, List, Optional


class Span:
    __slots__ = ("name", "parent", "trace_id", "span_id", "parent_id",
                 "start", "end", "attrs", "tid")

    def __init__(self, name, parent, start, tid, trace_id=None,
                 span_id=None, parent_id=None):
        self.name = name
        self.parent = parent
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = None
        self.attrs: Dict[str, object] = {}
        self.tid = tid


def _split_traceparent(traceparent: str):
    """`00-<trace>-<span>-<flags>` -> (trace id, span id), or None."""
    try:
        _v, trace_id, span_id, _f = traceparent.split("-")
    except ValueError:
        return None
    return trace_id, span_id


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
    def _open(self, s: Span):
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter_ns()
            stack.pop()
            with self._lock:
                self._spans.append(s)

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:  # a root, or the remote parent `adopt_traceparent` set
            trace_id = getattr(self._local, "remote_trace", None) \
                or uuid.uuid4().hex
            parent_id = getattr(self._local, "remote_parent", None)
        s = Span(name, parent.name if parent else None,
                 time.perf_counter_ns(), threading.get_ident(),
                 trace_id, uuid.uuid4().hex[:16], parent_id)
        s.attrs.update(attrs)
        with self._open(s):
            yield s

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

    # -- W3C propagation -------------------------------------------------------

    def current_traceparent(self) -> str:
        """The innermost open span of this thread as a W3C traceparent; a
        fresh trace's when none is open."""
        stack = self._stack()
        if stack:
            s = stack[-1]
            return f"00-{s.trace_id}-{s.span_id}-01"
        return f"00-{uuid.uuid4().hex}-{uuid.uuid4().hex[:16]}-01"

    def adopt_traceparent(self, traceparent: str) -> None:
        """Continue a remote trace in this thread: the next root span
        takes its trace id and its span as parent.  A malformed string
        is ignored."""
        ids = _split_traceparent(traceparent)
        if ids is None:
            return
        self._local.remote_trace, self._local.remote_parent = ids

    @contextmanager
    def remote_span(self, name: str, traceparent: str, **attrs):
        """A span continuing the trace of `traceparent` (the server side
        of a fetch); a malformed string starts a fresh trace."""
        if not self.enabled:
            yield None
            return
        ids = _split_traceparent(traceparent)
        trace_id, parent_id = ids if ids else (uuid.uuid4().hex, None)
        s = Span(name, None, time.perf_counter_ns(), threading.get_ident(),
                 trace_id, uuid.uuid4().hex[:16], parent_id)
        s.attrs.update(attrs)
        with self._open(s):
            yield s

    # -- export ----------------------------------------------------------------

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
                    "args": {**s.attrs, "parent": s.parent,
                             "trace_id": s.trace_id, "span_id": s.span_id,
                             "parent_id": s.parent_id}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return len(events)

    def export_otlp(self, endpoint: str) -> bool:
        """False where the `opentelemetry` package is absent; where it is
        installed the exporter is not wired, and this raises, as the
        reference does."""
        try:
            from opentelemetry import trace as _  # noqa: F401
        except ImportError:
            return False
        raise NotImplementedError("wire to opentelemetry SDK")


#: process-global tracer
TRACER = Tracer()
