"""Runtime counters, the internal event trace and the access tracer
(port of `liquid_tpu/cache/observer.py`).

The event trace (`event`, `consume_event_trace`) is what the snapshot
tests compare; the access tracer (`start_trace`, `record_access`,
`flush_trace_parquet`) records (time, op, entry, bytes) rows and writes
them as parquet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

from liquid_tpu_torch.utils import sync as _sync

#: the reference's counter names
COUNTERS = (
    "gets", "inserts", "predicate_evals", "predicate_evals_on_encoded",
    "squeeze_io_saved", "squeeze_io_reads",
    "transcodes", "squeezes", "evict_to_disk", "removes",
    "hydrations", "cache_hits", "cache_misses",
    "disk_reads", "disk_writes", "dynamic_filter_prunes",
)


class RuntimeStats:
    def __init__(self):
        self._lock = _sync.Lock()
        self._c = {k: 0 for k in COUNTERS}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)

    def reset(self) -> None:
        with self._lock:
            for k in self._c:
                self._c[k] = 0


@dataclass(frozen=True)
class Event:
    kind: str      # Insert | Transcode | Squeeze | EvictToDisk | Remove |
                   # Hydrate | DiskRead | Drop
    entry_id: int
    detail: str = ""


@dataclass
class TraceRecord:
    """One access-trace row."""

    ts: float
    op: str
    entry_id: int
    nbytes: int


class Observer:
    def __init__(self, trace_events: bool = False):
        self.stats = RuntimeStats()
        self._trace_events = trace_events
        self._events: List[Event] = []
        self._events_lock = _sync.Lock()
        self._tracer: Optional[List[TraceRecord]] = None
        self._tracer_lock = _sync.Lock()

    def event(self, kind: str, entry_id: int, detail: str = "") -> None:
        if self._trace_events:
            with self._events_lock:
                self._events.append(Event(kind, entry_id, detail))

    def consume_event_trace(self) -> List[Event]:
        with self._events_lock:
            out, self._events = self._events, []
            return out

    # -- access tracer ----------------------------------------------------------

    def start_trace(self) -> None:
        with self._tracer_lock:
            self._tracer = []

    def stop_trace(self) -> List[TraceRecord]:
        with self._tracer_lock:
            out, self._tracer = self._tracer or [], None
            return out

    def record_access(self, op: str, entry_id: int, nbytes: int = 0) -> None:
        with self._tracer_lock:
            if self._tracer is not None:
                self._tracer.append(TraceRecord(time.time(), op, entry_id,
                                                nbytes))

    def flush_trace_parquet(self, path: str) -> int:
        """Stop the trace and write its rows to a parquet file -> rows."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        recs = self.stop_trace()
        pq.write_table(pa.table({
            "ts": pa.array([r.ts for r in recs], pa.float64()),
            "op": pa.array([r.op for r in recs], pa.string()),
            "entry_id": pa.array([r.entry_id for r in recs], pa.uint64()),
            "nbytes": pa.array([r.nbytes for r in recs], pa.int64()),
        }), path)
        return len(recs)
