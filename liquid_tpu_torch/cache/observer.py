"""Runtime counters and the internal event trace (port of
`liquid_tpu/cache/observer.py`, counters and events)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from liquid_tpu_torch.utils import sync as _sync

#: the reference's counter names; the disk and squeeze ones stay 0 until
#: those tiers are ported
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


@dataclass(frozen=True)
class Event:
    kind: str      # Insert | Transcode | Remove | ...
    entry_id: int
    detail: str = ""


class Observer:
    def __init__(self, trace_events: bool = False):
        self.stats = RuntimeStats()
        self._trace_events = trace_events
        self._events: List[Event] = []
        self._events_lock = _sync.Lock()

    def event(self, kind: str, entry_id: int, detail: str = "") -> None:
        if self._trace_events:
            with self._events_lock:
                self._events.append(Event(kind, entry_id, detail))

    def consume_event_trace(self) -> List[Event]:
        with self._events_lock:
            out, self._events = self._events, []
            return out
