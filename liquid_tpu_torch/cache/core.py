"""LiquidCache: the encoded-column cache runtime (port of
`liquid_tpu/cache/core.py`).

Entries are keyed by a 64-bit id (file, row group, column, batch) and
hold one 8192-row block in one of five states: MEMORY_ARROW,
MEMORY_LIQUID, MEMORY_SQUEEZED (a narrow resident form whose exact bytes
lie on disk), DISK_LIQUID and DISK_ARROW.  An insert that does not fit
the memory budget asks the cache policy for victims and walks each one
down the squeeze policy's ladder until the new block fits; with no
victim left, the block itself goes to disk (`insert` returns False), or
is dropped when the disk budget is full too.  A read of a squeezed or
disk entry may hydrate it back to memory (the hydration policy).  The
disk is a block store (`cache/store.py`) of Liquid IPC bytes
(`arrays/ipc.py`) or arrow IPC bytes.

The cache owns the `device` its queries run on; encoded blocks stay on
the host until a query uploads them.  The classic scan evaluates
predicates on the encodings (`eval_predicate_many`: the primitive blocks
of one width bucket stacked and compared in one K1 launch,
`ops/bitpack.cmp_const_op_many`, a bucket of one block included; string
blocks by dictionary verdicts and one gather; squeezed and disk entries
one by one through `eval_predicate`) and decodes blocks in batches
(`get_arrow_many`).  A string column trains one FSST compressor on its
first block and shares it with the column's later blocks
(`DefaultCacheMetadata`).  `epoch` moves on every entry mutation, the
coarse invalidation key of derived caches (fused plans, prep stacks).
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.arrays import ipc
from liquid_tpu_torch.arrays.base import BLOCK_ROWS, LiquidSqueezedArray
from liquid_tpu_torch.cache import policies as pol
from liquid_tpu_torch.cache import transcode as tc
from liquid_tpu_torch.cache.budget import BudgetAccounting
from liquid_tpu_torch.cache.expressions import (
    ExtractDate32, HintVote, VariantGet,
)
from liquid_tpu_torch.cache.observer import Observer
from liquid_tpu_torch.cache.store import BlockStore
from liquid_tpu_torch.device import resolve_device
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.utils import sync as _sync
from liquid_tpu_torch.utils.tracing import TRACER

# entry states (the reference's names)
MEMORY_ARROW = "memory_arrow"
MEMORY_LIQUID = "memory_liquid"
MEMORY_SQUEEZED = "memory_squeezed"
DISK_LIQUID = "disk_liquid"
DISK_ARROW = "disk_arrow"

_KIND_OF_STATE = {
    MEMORY_ARROW: pol.ARROW,
    MEMORY_LIQUID: pol.LIQUID,
    MEMORY_SQUEEZED: pol.SQUEEZED,
    DISK_LIQUID: pol.DISK,
    DISK_ARROW: pol.DISK,
}


class CacheEntry:
    __slots__ = ("state", "payload", "disk_range", "mem_bytes", "hint")

    def __init__(self, state, payload, disk_range=None, mem_bytes=0,
                 hint=None):
        self.state = state
        self.payload = payload  # pa.Array | LiquidArray | squeezed | None
        self.disk_range = disk_range  # (offset, len) | None
        self.mem_bytes = mem_bytes
        self.hint = hint


def _arrow_memory_bytes(arr: pa.Array) -> int:
    return sum(b.size for b in arr.buffers() if b is not None) + 64


class _SqueezeIo:
    """A squeezed entry's IO handler over the block store; counts its
    reads."""

    def __init__(self, cache: "LiquidCache", entry_id: int):
        self._cache = cache
        self._entry_id = entry_id

    def read(self, rng: Optional[Tuple[int, int]]) -> bytes:
        obs = self._cache.observer
        obs.stats.bump("squeeze_io_reads")
        obs.stats.bump("disk_reads")
        obs.event("DiskRead", self._entry_id)
        obs.record_access("squeeze_io_read", self._entry_id,
                          rng[1] if rng else 0)
        if rng is None:
            data = self._cache.store.get(self._entry_id)
            if data is None:
                raise KeyError(f"no backing for entry {self._entry_id}")
            return data
        return self._cache.store.read_range(rng)


class _SqueezeCtx:
    """What a SqueezePolicy gets besides the victim."""

    def __init__(self, cache: "LiquidCache", hint):
        self.squeeze_hint = hint
        self._cache = cache

    def transcode(self, arr: pa.Array):
        self._cache.observer.stats.bump("transcodes")
        return tc.transcode(arr, self.squeeze_hint)

    def arrow_bytes(self, arr: pa.Array) -> bytes:
        return ipc.arrow_to_bytes(arr)

    def squeeze_with_hint(self, liquid, hint):
        from liquid_tpu_torch.arrays.hybrid import squeeze_date32
        if isinstance(hint, ExtractDate32) and pa.types.is_date32(
                liquid.arrow_type):
            return squeeze_date32(liquid, hint.field)
        return None

    def squeeze_default(self, payload):
        """The liquid block's own squeeze, or the quantized integer form
        under the cache's "quantize" integer policy."""
        from liquid_tpu_torch.arrays.hybrid import squeeze_primitive_quantized
        from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
        if (self._cache.int_squeeze_mode == "quantize"
                and isinstance(payload, LiquidPrimitiveArray)):
            out = squeeze_primitive_quantized(payload)
            if out is not None:
                return out
        return payload.squeeze()


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
    """insert / get / eval_predicate over encoded column blocks."""

    def __init__(self, max_memory_bytes: int = 1 << 30,
                 max_disk_bytes: Optional[int] = None,
                 disk_path: Optional[str] = None, device=None,
                 cache_policy: Optional[pol.CachePolicy] = None,
                 squeeze_policy: Optional[pol.SqueezePolicy] = None,
                 hydration_policy: Optional[pol.HydrationPolicy] = None,
                 transcode_on_insert: bool = True,
                 batch_size: int = BLOCK_ROWS,
                 trace_events: bool = False,
                 int_squeeze_mode: str = "clamp"):
        if batch_size & (batch_size - 1):
            raise ValueError(f"batch_size {batch_size} is not a power of 2")
        if int_squeeze_mode not in ("clamp", "quantize"):
            raise ValueError(f"integer squeeze policy {int_squeeze_mode!r}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.budget = BudgetAccounting(max_memory_bytes, max_disk_bytes)
        #: the block store's file; None: a fresh temporary directory on
        #: the first disk write
        self.disk_path = disk_path
        self._store = None
        self.cache_policy = cache_policy or pol.LiquidPolicy()
        self.squeeze_policy = squeeze_policy or pol.TranscodeSqueezeEvict()
        self.hydration_policy = hydration_policy or pol.AlwaysHydrate()
        self.transcode_on_insert = transcode_on_insert
        self.int_squeeze_mode = int_squeeze_mode
        self.observer = Observer(trace_events=trace_events)
        self.metadata = DefaultCacheMetadata()
        self._entries: Dict[int, CacheEntry] = {}
        self._hints: Dict[int, HintVote] = {}
        self._lock = _sync.RLock()
        self.epoch = 0

    @property
    def store(self):
        """The block store (the native one), opened on first use."""
        if self._store is None:
            with self._lock:
                if self._store is None:
                    if self.disk_path is None:
                        self.disk_path = os.path.join(tempfile.mkdtemp(
                            prefix="liquid_tpu_torch_"), "store.bin")
                    self._store = BlockStore(self.disk_path)
        return self._store

    # -- hints -------------------------------------------------------------

    def record_hint(self, entry_id: int, hint) -> None:
        with self._lock:
            self._hints.setdefault(entry_id, HintVote()).record(hint)

    def _hint_for(self, entry_id: int):
        vote = self._hints.get(entry_id)
        return vote.majority() if vote else None

    # -- insert ------------------------------------------------------------

    @TRACER.trace("cache.insert")
    def insert(self, entry_id: int, arr: pa.Array, hint=None) -> bool:
        """Cache an arrow column block, transcoded when it has a liquid
        encoding.  Returns False when memory pressure sent it to disk or
        dropped it."""
        if isinstance(hint, VariantGet):
            raise NotImplementedError(
                "VariantGet hints need the variant (JSON) arrays of "
                "arrays/variant.py, which are not ported yet")
        obs = self.observer
        obs.stats.bump("inserts")
        obs.record_access("insert", entry_id, _arrow_memory_bytes(arr))
        if hint is not None:
            self.record_hint(entry_id, hint)
        hint = hint if hint is not None else self._hint_for(entry_id)
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
                return self._insert_payload(entry_id, MEMORY_LIQUID, liquid,
                                            liquid.memory_bytes(), hint)
        return self._insert_payload(entry_id, MEMORY_ARROW, arr,
                                    _arrow_memory_bytes(arr), hint)

    def _insert_payload(self, entry_id, state, payload, nbytes, hint) -> bool:
        # the replacement loop: squeeze victims until the reservation fits
        while not self.budget.try_reserve_memory(nbytes):
            _sync.yield_now()
            victims = [v for v in self.cache_policy.find_memory_victims(8)
                       if v != entry_id]
            if not victims:
                return self._insert_to_disk(entry_id, state, payload, hint)
            for v in victims:
                self._squeeze_victim(v)
        with self._lock:
            old = self._entries.get(entry_id)
            if old is not None:
                self._release_entry(entry_id, old)
            self._entries[entry_id] = CacheEntry(state, payload,
                                                 mem_bytes=nbytes, hint=hint)
            self.epoch += 1
            self.cache_policy.notify_inserted(entry_id, _KIND_OF_STATE[state])
        self.observer.event("Insert", entry_id, state)
        return True

    def _insert_to_disk(self, entry_id, state, payload, hint) -> bool:
        """No memory victim left: write the incoming block to disk."""
        if state == MEMORY_ARROW:
            data, new_state = ipc.arrow_to_bytes(payload), DISK_ARROW
        else:
            data, new_state = payload.to_bytes(), DISK_LIQUID
        if not self._write_disk(entry_id, data):
            self.observer.event("Drop", entry_id)
            return False
        with self._lock:
            old = self._entries.get(entry_id)
            if old is not None:
                self._release_entry(entry_id, old)
            self._entries[entry_id] = CacheEntry(
                new_state, None, disk_range=self.store.range_of(entry_id),
                mem_bytes=0, hint=hint)
            self.epoch += 1
            self.cache_policy.notify_inserted(entry_id, pol.DISK)
        self.observer.event("EvictToDisk", entry_id, "insert_overflow")
        return False

    def _write_disk(self, entry_id: int, data: bytes) -> bool:
        """A disk write under the disk budget: disk victims are removed
        until it fits.  False when none is left."""
        old = self.store.range_of(entry_id)
        if old is not None:
            # put() replaces the record: release the old reservation
            self.budget.release_disk(old[1])
        while not self.budget.try_reserve_disk(len(data)):
            victims = [v for v in self.cache_policy.find_disk_victims(8)
                       if v != entry_id]
            if not victims:
                return False
            for v in victims:
                self._remove_disk_victim(v)
        self.store.put(entry_id, data)
        self.observer.stats.bump("disk_writes")
        return True

    def _remove_disk_victim(self, entry_id: int) -> None:
        with self._lock:
            e = self._entries.pop(entry_id, None)
            if e is None:
                return
            self._release_entry(entry_id, e)
        self.observer.stats.bump("removes")
        self.observer.event("Remove", entry_id, "disk_victim")

    def _release_entry(self, entry_id: int, e: CacheEntry) -> None:
        """Release the memory and disk `e` holds (caller holds the
        lock)."""
        self.epoch += 1
        if e.mem_bytes:
            self.budget.release_memory(e.mem_bytes)
        if self._store is not None:
            freed = self._store.remove(entry_id)
            if freed:
                self.budget.release_disk(freed)
        self.cache_policy.notify_removed(entry_id)

    # -- the squeeze pipeline ----------------------------------------------

    def _squeeze_victim(self, entry_id: int) -> None:
        with self._lock:
            e = self._entries.get(entry_id)
            if e is None:
                return
            ctx = _SqueezeCtx(self, e.hint)
            outcome = self.squeeze_policy.squeeze(e.state, e.payload, ctx)
            if outcome[0] == pol.REMOVE:
                self._entries.pop(entry_id, None)
                self._release_entry(entry_id, e)
                self.observer.stats.bump("removes")
                self.observer.event("Remove", entry_id)
                return
            _, new_state, new_payload, to_write = outcome
            if to_write is not None:
                if not self._write_disk(entry_id, to_write):
                    # disk full: drop the entry
                    self._entries.pop(entry_id, None)
                    self._release_entry(entry_id, e)
                    self.observer.event("Drop", entry_id, "disk_full")
                    return
                rng = self.store.range_of(entry_id)
            else:
                rng = e.disk_range
            new_mem = 0
            if new_payload is not None:
                new_mem = (_arrow_memory_bytes(new_payload)
                           if isinstance(new_payload, pa.Array)
                           else new_payload.memory_bytes())
                if isinstance(new_payload, LiquidSqueezedArray):
                    new_payload._disk_range = rng
            self.budget.force_update_memory_usage(e.mem_bytes, new_mem)
            e.state, e.payload, e.disk_range, e.mem_bytes = (
                new_state, new_payload, rng, new_mem)
            self.epoch += 1
            self.cache_policy.notify_state_changed(
                entry_id, _KIND_OF_STATE[new_state])
        self.observer.stats.bump("squeezes")
        self.observer.event("Squeeze", entry_id, new_state)

    # -- get -----------------------------------------------------------------

    @TRACER.trace("cache.get")
    def get(self, entry_id: int, selection: Optional[torch.Tensor] = None
            ) -> Optional[pa.Array]:
        """The block as arrow (a squeezed or disk entry reads its backing
        and may hydrate), or None; `selection` (packed words) keeps only
        its rows."""
        obs = self.observer
        obs.stats.bump("gets")
        with self._lock:
            e = self._entries.get(entry_id)
            if e is None:
                obs.stats.bump("cache_misses")
                return None
            obs.stats.bump("cache_hits")
            obs.record_access("get", entry_id, e.mem_bytes)
            accessed = getattr(self.cache_policy, "notify_accessed", None)
            if accessed is not None:
                accessed(entry_id)
            arr = self._read_arrow(entry_id, e)
        if arr is None:
            return None
        if selection is not None:
            sel = mops.unpack_bits(selection).cpu().numpy()[: len(arr)]
            arr = arr.take(pa.array(np.flatnonzero(sel), type=pa.int64()))
        return arr

    def get_component(self, entry_id: int, field: str):
        """A date field read from a squeezed date32 entry with no IO ->
        (values, validity) on the cache's device, or None."""
        from liquid_tpu_torch.arrays.hybrid import SqueezedDate32Array
        with self._lock:
            e = self._entries.get(entry_id)
            if e is None or e.state != MEMORY_SQUEEZED or not isinstance(
                    e.payload, SqueezedDate32Array):
                return None
            out = e.payload.to_component_array(field, self.device)
            if out is not None:
                self.observer.stats.bump("squeeze_io_saved")
            return out

    def _read_arrow(self, entry_id, e) -> Optional[pa.Array]:
        if e.state == MEMORY_ARROW:
            return e.payload
        if e.state == MEMORY_LIQUID:
            return e.payload.to_arrow()
        if e.state == MEMORY_SQUEEZED:
            # the backing read once: decoded, then hydrated when it fits
            liquid = e.payload._read_full(_SqueezeIo(self, entry_id))
            arr = liquid.to_arrow()
            self._maybe_hydrate(entry_id, e, arr, liquid)
            return arr
        data = self.store.get(entry_id)
        if data is None:
            return None
        self.observer.stats.bump("disk_reads")
        if e.state == DISK_ARROW:
            arr = ipc.arrow_from_bytes(data)
            self._maybe_hydrate(entry_id, e, arr)
            return arr
        liquid = ipc.deserialize(data)
        arr = liquid.to_arrow()
        self._maybe_hydrate(entry_id, e, arr, liquid)
        return arr

    def _maybe_hydrate(self, entry_id, e, arr, liquid=None) -> None:
        """Promote a squeezed or disk entry back to memory when the
        hydration policy says so and it fits (caller holds the lock)."""
        if not self.hydration_policy.should_hydrate(e.state):
            return
        if e.state in (MEMORY_SQUEEZED, DISK_LIQUID):
            payload = liquid if liquid is not None else ipc.deserialize(
                self.store.get(entry_id))
            state, nbytes = MEMORY_LIQUID, payload.memory_bytes()
        else:  # DISK_ARROW
            payload, state, nbytes = arr, MEMORY_ARROW, _arrow_memory_bytes(
                arr)
        if not self.budget.try_update_memory_usage(e.mem_bytes, nbytes):
            return  # no room: stays where it is
        e.state, e.payload, e.mem_bytes = state, payload, nbytes
        self.epoch += 1
        self.cache_policy.notify_state_changed(entry_id,
                                               _KIND_OF_STATE[state])
        self.observer.stats.bump("hydrations")
        self.observer.event("Hydrate", entry_id, state)

    # -- predicate evaluation on the encodings ------------------------------

    @TRACER.trace("cache.eval_predicate")
    def eval_predicate(self, entry_id: int, pred):
        """A BoolMask of `pred` evaluated on the encoded entry, or None
        (the entry is absent, arrow, or has no encoded form for `pred`:
        the caller decodes and evaluates).  A squeezed entry reads its
        backing only for the rows its resident form cannot decide; a
        DiskLiquid entry is read, evaluated, and may hydrate."""
        obs = self.observer
        obs.stats.bump("predicate_evals")
        with self._lock:
            e = self._entries.get(entry_id)
            if e is None:
                return None
            obs.record_access("eval_predicate", entry_id, 0)
            if e.state == MEMORY_LIQUID:
                out = e.payload.try_eval_predicate(pred, self.device)
            elif e.state == MEMORY_SQUEEZED:
                before = obs.stats.get("squeeze_io_reads")
                out = e.payload.try_eval_predicate(
                    pred, _SqueezeIo(self, entry_id), self.device)
                if out is not None and obs.stats.get(
                        "squeeze_io_reads") == before:
                    obs.stats.bump("squeeze_io_saved")
            elif e.state == DISK_LIQUID:
                data = self.store.get(entry_id)
                if data is None:
                    return None
                obs.stats.bump("disk_reads")
                liquid = ipc.deserialize(data)
                out = liquid.try_eval_predicate(pred, self.device)
                self._maybe_hydrate(entry_id, e, None, liquid)
            else:  # arrow forms: the caller decodes and evaluates
                return None
            if out is not None:
                obs.stats.bump("predicate_evals_on_encoded")
            return out

    @TRACER.trace("cache.eval_predicate_many")
    def eval_predicate_many(self, entry_ids, pred):
        """Batched evaluation over many entries (a row group's blocks of
        one column): resident primitive blocks of one width bucket are
        stacked and compared in ONE K1 launch (`bitpack.cmp_const_op_many`,
        a bucket of one block too), resident string blocks gather their
        dictionary verdicts in one call, the rest (squeezed, disk, other
        encodings) go one by one through `eval_predicate`.
        -> BoolMask | None per entry id."""
        from liquid_tpu_torch.arrays.byteview import (
            LiquidByteViewArray, _verdict_gather_many)
        from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
        from liquid_tpu_torch.device import u64_to_i64, words_to_tensor
        from liquid_tpu_torch.ops import bitpack as bp
        obs = self.observer
        dev = self.device
        results: list = [None] * len(entry_ids)
        prim: Dict[tuple, list] = {}  # (bucket, op) -> [(i, payload, u)]
        bv: list = []                 # [(i, payload)] string blocks
        slow: list = []
        with self._lock:
            for i, eid in enumerate(entry_ids):
                e = self._entries.get(eid)
                if e is None:
                    continue
                p = e.payload
                if e.state == MEMORY_LIQUID and isinstance(
                        p, LiquidPrimitiveArray):
                    plan = p.packed_plan(pred)
                    if plan is None:
                        continue
                    obs.stats.bump("predicate_evals")
                    obs.stats.bump("predicate_evals_on_encoded")
                    if plan[0] == "const":
                        results[i] = p._const_mask(plan[1], dev)
                    else:
                        prim.setdefault((p.planes_np.shape[0], plan[2]),
                                        []).append((i, p, plan[1]))
                elif e.state == MEMORY_LIQUID and isinstance(
                        p, LiquidByteViewArray):
                    bv.append((i, p))
                else:
                    slow.append((i, eid))
        for (_bucket, op), items in prim.items():
            stack = words_to_tensor(np.stack([p.planes_np
                                              for _, p, _ in items]), dev)
            cs = torch.from_numpy(u64_to_i64(
                [u for _, _, u in items])).to(dev)
            bits_all = bp.cmp_const_op_many(stack, cs, op)
            valid_all = words_to_tensor(np.stack([
                p.validity_np if p.validity_np is not None
                else mops.all_set_host(BLOCK_ROWS, p.length)
                for _, p, _ in items]), dev)
            for j, (i, _p, _u) in enumerate(items):
                results[i] = mops.BoolMask(bits_all[j], valid_all[j])
        evald = []
        for i, p in bv:
            vd = p.dict_verdict(pred)
            if vd is None:
                slow.append((i, entry_ids[i]))
                continue
            obs.stats.bump("predicate_evals")
            obs.stats.bump("predicate_evals_on_encoded")
            evald.append((i, p, vd))
        if len(evald) == 1:
            i, p, vd = evald[0]
            results[i] = p._mask_from_verdict(vd, dev)
        elif evald:
            # per-dictionary verdicts padded to the widest, ONE gather
            max_d = max(len(vd) for _, _, vd in evald)
            verdicts = np.zeros((len(evald), max_d), dtype=bool)
            for j, (_i, _p, vd) in enumerate(evald):
                verdicts[j, :len(vd)] = vd
            codes = torch.from_numpy(np.stack(
                [p.codes_np for _, p, _ in evald])).to(dev)
            bits_all = _verdict_gather_many(
                torch.from_numpy(verdicts).to(dev), codes)
            valid_all = words_to_tensor(np.stack([
                p.validity_np if p.validity_np is not None
                else mops.all_set_host(BLOCK_ROWS, p.length)
                for _, p, _ in evald]), dev)
            for j, (i, _p, _vd) in enumerate(evald):
                results[i] = mops.BoolMask(bits_all[j], valid_all[j])
        for i, eid in slow:
            results[i] = self.eval_predicate(eid, pred)
        return results

    @TRACER.trace("cache.get_arrow_many")
    def get_arrow_many(self, entry_ids):
        """Batched decode: resident primitive and float bit-plane blocks
        unpack in ONE call per width bucket and ONE fetch; the rest
        (squeezed and disk entries included) go through `get`.
        -> pa.Array | None per entry id."""
        from liquid_tpu_torch.device import words_to_tensor
        from liquid_tpu_torch.ops import bitpack as bp
        obs = self.observer
        results: list = [None] * len(entry_ids)
        grouped: Dict[int, list] = {}  # bucket -> [(i, payload)]
        slow: list = []
        with self._lock:
            for i, eid in enumerate(entry_ids):
                e = self._entries.get(eid)
                if e is None:
                    obs.stats.bump("gets")
                    obs.stats.bump("cache_misses")
                    continue
                p = e.payload
                if e.state == MEMORY_LIQUID and hasattr(
                        p, "decode_from_offsets") and hasattr(p, "planes_np"):
                    obs.stats.bump("gets")
                    obs.stats.bump("cache_hits")
                    obs.record_access("get", eid, e.mem_bytes)
                    grouped.setdefault(p.planes_np.shape[0], []).append(
                        (i, p))
                else:
                    slow.append((i, eid))
        for _bucket, items in grouped.items():
            if len(items) == 1:
                i, p = items[0]
                results[i] = p.to_arrow()
                continue
            stack = words_to_tensor(np.stack([p.planes_np
                                              for _, p in items]),
                                    self.device)
            offs = bp.unpack_bitplanes_many(stack).cpu().numpy()
            for j, (i, p) in enumerate(items):
                results[i] = p.decode_from_offsets(offs[j])
        for i, eid in slow:
            results[i] = self.get(eid)
        return results

    # -- admin -------------------------------------------------------------

    def contains(self, entry_id: int) -> bool:
        with self._lock:
            return entry_id in self._entries

    def entry_state(self, entry_id: int) -> Optional[str]:
        with self._lock:
            e = self._entries.get(entry_id)
            return e.state if e else None

    def flush_all_to_disk(self) -> None:
        """Walk every memory entry down the squeeze ladder to disk."""
        with self._lock:
            for eid in list(self._entries):
                e = self._entries[eid]
                while e.state in (MEMORY_ARROW, MEMORY_LIQUID,
                                  MEMORY_SQUEEZED):
                    self._squeeze_victim(eid)
                    e = self._entries.get(eid)
                    if e is None:
                        break

    def reset(self) -> None:
        with self._lock:
            for eid in list(self._entries):
                self._release_entry(eid, self._entries.pop(eid))
            self._hints.clear()

    def remove_file(self, file_id: int) -> None:
        """Drop every entry of one registered file (the file id is the
        entry id's top 16 bits), releasing its memory and disk."""
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
        s["disk_used"] = self.budget.disk_used
        return s


class LiquidCacheBuilder:
    """Fluent builder.  Defaults: 1 GB memory, unbounded disk in a fresh
    temporary directory, LiquidPolicy, TranscodeSqueezeEvict,
    AlwaysHydrate, transcode on insert, and the CUDA device."""

    def __init__(self):
        self._kw = {}

    def with_max_memory_bytes(self, n: int):
        self._kw["max_memory_bytes"] = n
        return self

    def with_max_disk_bytes(self, n: int):
        self._kw["max_disk_bytes"] = n
        return self

    def with_disk_path(self, p: str):
        self._kw["disk_path"] = p
        return self

    def with_device(self, device):
        self._kw["device"] = device
        return self

    def with_cache_policy(self, p: pol.CachePolicy):
        self._kw["cache_policy"] = p
        return self

    def with_squeeze_policy(self, p: pol.SqueezePolicy):
        self._kw["squeeze_policy"] = p
        return self

    def with_hydration_policy(self, p: pol.HydrationPolicy):
        self._kw["hydration_policy"] = p
        return self

    def with_batch_size(self, n: int):
        self._kw["batch_size"] = n
        return self

    def with_transcode_on_insert(self, b: bool):
        self._kw["transcode_on_insert"] = b
        return self

    def with_trace_events(self, b: bool = True):
        self._kw["trace_events"] = b
        return self

    def with_integer_squeeze_policy(self, mode: str):
        """"clamp" (the default) or "quantize"."""
        self._kw["int_squeeze_mode"] = mode
        return self

    def build(self) -> LiquidCache:
        return LiquidCache(**self._kw)
