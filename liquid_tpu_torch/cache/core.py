"""LiquidCache: the encoded-column cache runtime (port of
`liquid_tpu/cache/core.py`, memory tiers).

Entries are keyed by a 64-bit id (file, row group, column, batch) and
hold one 8192-row block either as arrow (MEMORY_ARROW) or in its liquid
encoding (MEMORY_LIQUID).  The reference moves entries on through
squeezed and disk states under memory pressure; those tiers are not
ported yet, so an insert that does not fit the memory budget raises
NotImplementedError instead of spilling.

The cache owns the `device` its queries run on; encoded blocks stay on
the host until the fused path stacks them into device tensors.  A string
column trains one FSST compressor on its first block and shares it with
the column's later blocks (`DefaultCacheMetadata`).
"""
from __future__ import annotations

from typing import Dict, Optional

import pyarrow as pa

from liquid_tpu_torch.cache import policies as pol
from liquid_tpu_torch.cache import transcode as tc
from liquid_tpu_torch.cache.budget import BudgetAccounting
from liquid_tpu_torch.cache.expressions import HintVote
from liquid_tpu_torch.cache.observer import Observer
from liquid_tpu_torch.device import resolve_device
from liquid_tpu_torch.utils import sync as _sync
from liquid_tpu_torch.utils.tracing import TRACER

# entry states (the reference's names; the squeezed and disk states are
# not ported)
MEMORY_ARROW = "memory_arrow"
MEMORY_LIQUID = "memory_liquid"

_KIND_OF_STATE = {MEMORY_ARROW: pol.ARROW, MEMORY_LIQUID: pol.LIQUID}


class CacheEntry:
    __slots__ = ("state", "payload", "mem_bytes", "hint")

    def __init__(self, state, payload, mem_bytes=0, hint=None):
        self.state = state
        self.payload = payload      # pa.Array | LiquidArray
        self.mem_bytes = mem_bytes
        self.hint = hint


def _arrow_memory_bytes(arr: pa.Array) -> int:
    return sum(b.size for b in arr.buffers() if b is not None) + 64


class DefaultCacheMetadata:
    """Per-column shared state: FSST compressors keyed by the entry id
    with its 16-bit batch field stripped."""

    def __init__(self):
        self._compressors: Dict[int, object] = {}

    def column_key(self, entry_id: int) -> int:
        return entry_id >> 16

    def compressor_for(self, entry_id: int):
        return self._compressors.get(self.column_key(entry_id))

    def store_compressor(self, entry_id: int, comp) -> None:
        self._compressors.setdefault(self.column_key(entry_id), comp)


class LiquidCache:
    """insert / get over encoded column blocks."""

    def __init__(self, max_memory_bytes: int = 1 << 30, device=None,
                 cache_policy: Optional[pol.CachePolicy] = None,
                 transcode_on_insert: bool = True,
                 trace_events: bool = False):
        self.device = resolve_device(device)
        self.budget = BudgetAccounting(max_memory_bytes)
        self.cache_policy = cache_policy or pol.LiquidPolicy()
        self.transcode_on_insert = transcode_on_insert
        self.observer = Observer(trace_events=trace_events)
        self.metadata = DefaultCacheMetadata()
        self._entries: Dict[int, CacheEntry] = {}
        self._hints: Dict[int, HintVote] = {}
        self._lock = _sync.RLock()
        #: bumped on every entry mutation: coarse invalidation key for
        #: derived caches (fused plans, prep stacks)
        self.epoch = 0

    # -- hints -------------------------------------------------------------

    def record_hint(self, entry_id: int, hint) -> None:
        with self._lock:
            self._hints.setdefault(entry_id, HintVote()).record(hint)

    def _hint_for(self, entry_id: int):
        vote = self._hints.get(entry_id)
        return vote.majority() if vote else None

    # -- insert ------------------------------------------------------------

    @TRACER.trace("cache.insert")
    def insert(self, entry_id: int, arr: pa.Array, hint=None) -> None:
        """Cache an arrow column block, transcoded when it has a liquid
        encoding.  Raises NotImplementedError when the block does not fit
        the memory budget (the spill tiers are not ported)."""
        obs = self.observer
        obs.stats.bump("inserts")
        if hint is not None:
            self.record_hint(entry_id, hint)
        hint = hint if hint is not None else self._hint_for(entry_id)
        liquid = None
        if self.transcode_on_insert:
            liquid = tc.transcode(
                arr, hint, compressor=self.metadata.compressor_for(entry_id))
        if liquid is not None:
            obs.stats.bump("transcodes")
            obs.event("Transcode", entry_id)
            fsst = getattr(liquid, "fsst", None)
            if fsst is not None:
                # share the trained compressor with the column's blocks
                self.metadata.store_compressor(entry_id, fsst.compressor)
            state, payload, nbytes = (MEMORY_LIQUID, liquid,
                                      liquid.memory_bytes())
        else:
            state, payload, nbytes = (MEMORY_ARROW, arr,
                                      _arrow_memory_bytes(arr))
        with self._lock:
            old = self._entries.pop(entry_id, None)
            if old is not None:
                self._release_entry(entry_id, old)
            if not self.budget.try_reserve_memory(nbytes):
                raise NotImplementedError(
                    f"cache memory budget ({self.budget.max_memory_bytes} "
                    f"bytes) exceeded: squeezing and disk spill are not "
                    f"ported yet")
            self._entries[entry_id] = CacheEntry(state, payload, nbytes, hint)
            self.epoch += 1
            self.cache_policy.notify_inserted(entry_id, _KIND_OF_STATE[state])
        obs.event("Insert", entry_id, state)

    def _release_entry(self, entry_id: int, e: CacheEntry) -> None:
        """Release the budget held by `e` (caller holds the lock)."""
        self.epoch += 1
        if e.mem_bytes:
            self.budget.release_memory(e.mem_bytes)
        self.cache_policy.notify_removed(entry_id)

    # -- get ---------------------------------------------------------------

    @TRACER.trace("cache.get")
    def get(self, entry_id: int) -> Optional[pa.Array]:
        obs = self.observer
        obs.stats.bump("gets")
        with self._lock:
            e = self._entries.get(entry_id)
            if e is None:
                obs.stats.bump("cache_misses")
                return None
            obs.stats.bump("cache_hits")
            state, payload = e.state, e.payload
        return payload if state == MEMORY_ARROW else payload.to_arrow()

    # -- admin -------------------------------------------------------------

    def contains(self, entry_id: int) -> bool:
        with self._lock:
            return entry_id in self._entries

    def reset(self) -> None:
        with self._lock:
            for eid in list(self._entries):
                self._release_entry(eid, self._entries.pop(eid))
            self._hints.clear()

    def remove_file(self, file_id: int) -> None:
        """Drop every entry of one registered file (the file id is the
        entry id's top 16 bits)."""
        with self._lock:
            for eid in list(self._entries):
                if eid >> 48 == file_id:
                    self._release_entry(eid, self._entries.pop(eid))

    def stats(self) -> dict:
        s = self.observer.stats.snapshot()
        with self._lock:
            states: Dict[str, int] = {}
            for e in self._entries.values():
                states[e.state] = states.get(e.state, 0) + 1
            s["entries"] = len(self._entries)
        s["by_state"] = states
        s["memory_used"] = self.budget.memory_used
        return s


class LiquidCacheBuilder:
    """Fluent builder.  Defaults: 1 GB memory, LiquidPolicy, transcode
    on insert, and the CUDA device."""

    def __init__(self):
        self._kw = {}

    def with_max_memory_bytes(self, n: int):
        self._kw["max_memory_bytes"] = n
        return self

    def with_device(self, device):
        self._kw["device"] = device
        return self

    def with_cache_policy(self, p: pol.CachePolicy):
        self._kw["cache_policy"] = p
        return self

    def with_transcode_on_insert(self, b: bool):
        self._kw["transcode_on_insert"] = b
        return self

    def with_trace_events(self, b: bool = True):
        self._kw["trace_events"] = b
        return self

    def build(self) -> LiquidCache:
        return LiquidCache(**self._kw)
