"""Span tracing, W3C trace propagation and Chrome trace-event export (port
of `liquid_tpu/utils/tracing.py`).

A process-wide recorder of context-manager / decorator spans on a
thread-local stack; disabled until `TRACER.enable()`, when a span costs
one attribute check and hands back one shared no-op context.  Each span
carries a trace id, its own span id and its parent's (`parent` keeps the
parent span's name).  Span ids come from a per-process counter over a
random base, in W3C form (16 hex digits); a root span draws a fresh
128-bit trace id.  Across the client / server boundary a span travels as
a W3C `traceparent` string in the Flight ticket (`current_traceparent` on
the client, `remote_span` on the server; reference `:106-146`).
`export_chrome_trace` writes JSON that Perfetto and chrome://tracing load,
each span's attributes in its `args`.

`to_host` and `to_device` are the query path's copies between host and
card under `wait.fetch` and `wait.upload` spans: the time the host waits
for the card, named by the program.  Spans open and close on the thread
that runs them and are all read on the host's `time.perf_counter_ns`
clock.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from contextlib import nullcontext
from typing import Dict, List, Optional

#: what a disabled tracer's `span` returns: entering it yields None
_NOOP = nullcontext()
#: span ids count up from a random base, so that two processes' ids differ
_ID_BASE = int.from_bytes(os.urandom(8), "little")
_IDS = itertools.count(1)


def _span_id() -> str:
    """The next span id of this process: 16 hex digits, as W3C wants."""
    return f"{(_ID_BASE + next(_IDS)) & ((1 << 64) - 1):016x}"


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

    def span(self, name: str, **attrs):
        """A context manager that records the span `name` (entering it
        gives the Span, whose `attrs` may gain keys while it is open), or
        the shared no-op context while the tracer is disabled."""
        if not self.enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:  # a root, or the remote parent `adopt_traceparent` set
            trace_id = getattr(self._local, "remote_trace", None) \
                or uuid.uuid4().hex
            parent_id = getattr(self._local, "remote_parent", None)
        s = Span(name, parent.name if parent else None, 0,
                 threading.get_ident(), trace_id, _span_id(), parent_id)
        s.attrs.update(attrs)
        return _Open(self, s, stack)

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

    def remote_span(self, name: str, traceparent: str, **attrs):
        """A span continuing the trace of `traceparent` (the server side
        of a fetch); a malformed string starts a fresh trace."""
        if not self.enabled:
            return _NOOP
        ids = _split_traceparent(traceparent)
        trace_id, parent_id = ids if ids else (uuid.uuid4().hex, None)
        s = Span(name, None, 0, threading.get_ident(), trace_id, _span_id(),
                 parent_id)
        s.attrs.update(attrs)
        return _Open(self, s, self._stack())

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


class _Open:
    """An enabled span as a context: pushed on this thread's stack on
    entry, stamped, popped and recorded on exit."""

    __slots__ = ("tracer", "span", "stack")

    def __init__(self, tracer: Tracer, span: Span, stack: list):
        self.tracer, self.span, self.stack = tracer, span, stack

    def __enter__(self) -> Span:
        self.stack.append(self.span)
        self.span.start = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end = time.perf_counter_ns()
        self.stack.pop()
        with self.tracer._lock:
            self.tracer._spans.append(s)
        return False


#: process-global tracer
TRACER = Tracer()


def to_host(t):
    """`t.cpu()`: a device-to-host copy, so the host waits for the card
    (for a CPU tensor, `t` itself), under a `wait.fetch` span."""
    if not TRACER.enabled:
        return t.cpu()
    with TRACER.span("wait.fetch"):
        return t.cpu()


def to_device(t, device):
    """`t.to(device)` under a `wait.upload` span: from pageable host
    memory the copy waits until the card has run everything enqueued
    before it (the runtime synchronizes the stream)."""
    if not TRACER.enabled:
        return t.to(device)
    with TRACER.span("wait.upload"):
        return t.to(device)
