"""Cache replacement, squeeze and hydration policies (port of
`liquid_tpu/cache/policies.py`).

- `CachePolicy` advises victims: `LiquidPolicy` keeps one FIFO queue per
  entry kind and drains Arrow, then Liquid, then Squeezed, with a
  separate Disk queue for disk victims; `FifoPolicy` is one FIFO over
  memory entries; `LruPolicy` moves an entry to the back when it is read.
  A popped entry is not advised again until a notify re-enqueues it.
- `SqueezePolicy` picks a victim's next form: `TranscodeSqueezeEvict`
  (the default) walks Arrow -> Liquid -> Squeezed (with disk backing) ->
  DiskLiquid -> gone; `TranscodeEvict` skips the squeezed stage; `Evict`
  never transcodes.
- `HydrationPolicy` decides whether a read promotes a disk or squeezed
  entry back to memory.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import List, Tuple

from liquid_tpu_torch.utils import sync as _sync

# entry kinds
ARROW = "arrow"
LIQUID = "liquid"
SQUEEZED = "squeezed"
DISK = "disk"          # DiskLiquid / DiskArrow

_MEMORY_ORDER = (ARROW, LIQUID, SQUEEZED)


class CachePolicy(abc.ABC):
    """Eviction advisor."""

    @abc.abstractmethod
    def notify_inserted(self, entry_id: int, kind: str) -> None: ...

    @abc.abstractmethod
    def notify_state_changed(self, entry_id: int, kind: str) -> None: ...

    @abc.abstractmethod
    def notify_removed(self, entry_id: int) -> None: ...

    @abc.abstractmethod
    def find_memory_victims(self, count: int) -> List[int]: ...

    @abc.abstractmethod
    def find_disk_victims(self, count: int) -> List[int]: ...


class LiquidPolicy(CachePolicy):
    """Four FIFO queues by kind; memory victims drain Arrow, then Liquid,
    then Squeezed."""

    def __init__(self):
        self._lock = _sync.Lock()
        self._queues = {k: OrderedDict() for k in _MEMORY_ORDER + (DISK,)}
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

    notify_state_changed = notify_inserted

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
                if len(out) >= count:
                    break
        return out

    def find_disk_victims(self, count: int) -> List[int]:
        out: List[int] = []
        with self._lock:
            q = self._queues[DISK]
            while q and len(out) < count:
                eid, _ = q.popitem(last=False)
                self._where.pop(eid, None)
                out.append(eid)
        return out


class FifoPolicy(CachePolicy):
    """One FIFO over all memory entries (the baseline policy)."""

    def __init__(self):
        self._lock = _sync.Lock()
        self._mem = OrderedDict()
        self._disk = OrderedDict()

    def notify_inserted(self, entry_id: int, kind: str) -> None:
        with self._lock:
            self._mem.pop(entry_id, None)
            self._disk.pop(entry_id, None)
            (self._disk if kind == DISK else self._mem)[entry_id] = True

    notify_state_changed = notify_inserted

    def notify_removed(self, entry_id: int) -> None:
        with self._lock:
            self._mem.pop(entry_id, None)
            self._disk.pop(entry_id, None)

    def find_memory_victims(self, count: int) -> List[int]:
        out = []
        with self._lock:
            while self._mem and len(out) < count:
                out.append(self._mem.popitem(last=False)[0])
        return out

    def find_disk_victims(self, count: int) -> List[int]:
        out = []
        with self._lock:
            while self._disk and len(out) < count:
                out.append(self._disk.popitem(last=False)[0])
        return out


class LruPolicy(FifoPolicy):
    """LRU over memory entries: `notify_accessed` moves an entry to the
    back of the queue."""

    def notify_accessed(self, entry_id: int) -> None:
        with self._lock:
            if entry_id in self._mem:
                self._mem.move_to_end(entry_id)


# -- squeeze policies -----------------------------------------------------------

#: outcome kinds
REPLACE = "replace"
REMOVE = "remove"


class SqueezePolicy(abc.ABC):
    """A victim's next form.  `squeeze(state, payload, ctx)` returns
    (REPLACE, new_state, new_payload, bytes_to_write | None) or (REMOVE,),
    where new_state is a `cache.core` state and `ctx` carries the
    transcoder and the squeeze hint."""

    @abc.abstractmethod
    def squeeze(self, state: str, payload, ctx) -> Tuple: ...


class TranscodeSqueezeEvict(SqueezePolicy):
    """The default pipeline."""

    def squeeze(self, state: str, payload, ctx):
        from liquid_tpu_torch.cache import core as c
        if state == c.MEMORY_ARROW:
            liquid = ctx.transcode(payload)
            if liquid is None:  # no liquid encoding: to disk as arrow
                return (REPLACE, c.DISK_ARROW, None, ctx.arrow_bytes(payload))
            return (REPLACE, c.MEMORY_LIQUID, liquid, None)
        if state == c.MEMORY_LIQUID:
            hint = ctx.squeeze_hint
            if hint is not None:
                out = ctx.squeeze_with_hint(payload, hint)
                if out is not None:
                    return (REPLACE, c.MEMORY_SQUEEZED, *out)
            out = ctx.squeeze_default(payload)
            if out is None:  # no squeezed form: to disk in liquid form
                return (REPLACE, c.DISK_LIQUID, None, payload.to_bytes())
            return (REPLACE, c.MEMORY_SQUEEZED, *out)
        if state == c.MEMORY_SQUEEZED:
            # the backing is already on disk: drop the resident part
            return (REPLACE, _disk_state_for(payload), None, None)
        return (REMOVE,)


def _disk_state_for(squeezed) -> str:
    """The disk state of a squeezed entry's backing (liquid IPC or arrow
    bytes), so that a read deserializes it right."""
    from liquid_tpu_torch.cache import core as c
    kind, _ = squeezed.disk_backing()
    return c.DISK_ARROW if kind == "arrow" else c.DISK_LIQUID


class TranscodeEvict(SqueezePolicy):
    """Arrow -> Liquid -> DiskLiquid -> gone (no squeezed stage)."""

    def squeeze(self, state: str, payload, ctx):
        from liquid_tpu_torch.cache import core as c
        if state == c.MEMORY_ARROW:
            liquid = ctx.transcode(payload)
            if liquid is None:
                return (REPLACE, c.DISK_ARROW, None, ctx.arrow_bytes(payload))
            return (REPLACE, c.MEMORY_LIQUID, liquid, None)
        if state == c.MEMORY_LIQUID:
            return (REPLACE, c.DISK_LIQUID, None, payload.to_bytes())
        if state == c.MEMORY_SQUEEZED:
            return (REPLACE, _disk_state_for(payload), None, None)
        return (REMOVE,)


class Evict(SqueezePolicy):
    """Never transcode: memory -> disk bytes as they are -> gone."""

    def squeeze(self, state: str, payload, ctx):
        from liquid_tpu_torch.cache import core as c
        if state == c.MEMORY_ARROW:
            return (REPLACE, c.DISK_ARROW, None, ctx.arrow_bytes(payload))
        if state == c.MEMORY_LIQUID:
            return (REPLACE, c.DISK_LIQUID, None, payload.to_bytes())
        if state == c.MEMORY_SQUEEZED:
            return (REPLACE, _disk_state_for(payload), None, None)
        return (REMOVE,)


# -- hydration policies ---------------------------------------------------------

class HydrationPolicy(abc.ABC):
    """Whether a read of a disk or squeezed entry promotes it."""

    @abc.abstractmethod
    def should_hydrate(self, state: str) -> bool: ...


class AlwaysHydrate(HydrationPolicy):
    def should_hydrate(self, state: str) -> bool:
        return True


class NoHydration(HydrationPolicy):
    def should_hydrate(self, state: str) -> bool:
        return False
