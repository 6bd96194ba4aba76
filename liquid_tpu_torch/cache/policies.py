"""Cache replacement advice (port of `liquid_tpu/cache/policies.py`,
the `CachePolicy` interface and `LiquidPolicy`).

`LiquidPolicy` keeps one FIFO queue per entry kind and advises Arrow
entries first, then Liquid.  The squeeze and hydration policies belong to
the squeezed and disk tiers, which the port does not have yet: asking the
builder for one raises.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import List

from liquid_tpu_torch.utils import sync as _sync

# entry kinds of the memory tiers
ARROW = "arrow"
LIQUID = "liquid"

_MEMORY_ORDER = (ARROW, LIQUID)


class CachePolicy(abc.ABC):
    """Eviction advisor."""

    @abc.abstractmethod
    def notify_inserted(self, entry_id: int, kind: str) -> None: ...

    @abc.abstractmethod
    def notify_removed(self, entry_id: int) -> None: ...

    @abc.abstractmethod
    def find_memory_victims(self, count: int) -> List[int]: ...


class LiquidPolicy(CachePolicy):
    """FIFO queue per kind; memory victims drain Arrow, then Liquid.
    A popped entry is not advised again until re-inserted."""

    def __init__(self):
        self._lock = _sync.Lock()
        self._queues = {k: OrderedDict() for k in _MEMORY_ORDER}
        self._where = {}  # entry_id -> kind

    def _remove_locked(self, entry_id: int) -> None:
        kind = self._where.pop(entry_id, None)
        if kind is not None:
            self._queues[kind].pop(entry_id, None)

    def notify_inserted(self, entry_id: int, kind: str) -> None:
        with self._lock:
            self._remove_locked(entry_id)
            self._queues[kind][entry_id] = True
            self._where[entry_id] = kind

    def notify_removed(self, entry_id: int) -> None:
        with self._lock:
            self._remove_locked(entry_id)

    def find_memory_victims(self, count: int) -> List[int]:
        out: List[int] = []
        with self._lock:
            for kind in _MEMORY_ORDER:
                q = self._queues[kind]
                while q and len(out) < count:
                    eid, _ = q.popitem(last=False)
                    self._where.pop(eid, None)
                    out.append(eid)
        return out
