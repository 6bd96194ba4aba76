"""LiquidCache: the encoded-column cache runtime (port of
`liquid_tpu/cache/core.py`, memory tiers).

Entries are keyed by a 64-bit id (file, row group, column, batch) and
hold one 8192-row block either as arrow (MEMORY_ARROW) or in its liquid
encoding (MEMORY_LIQUID).  The reference moves entries on through
squeezed and disk states under memory pressure; those tiers are not
ported yet, so an insert that does not fit the memory budget raises
NotImplementedError instead of spilling.

The cache owns the `device` its queries run on; encoded blocks stay on
the host until the fused path stacks them into device tensors.  The
classic scan evaluates predicates on the encodings
(`eval_predicate_many`: the primitive blocks of one width bucket stacked
and compared in one K1 launch, `ops/bitpack.cmp_const_op_many`; string
blocks by dictionary verdicts and one gather) and decodes blocks in
batches (`get_arrow_many`: one unpack per width bucket, one fetch).  A string
column trains one FSST compressor on its first block and shares it with
the column's later blocks (`DefaultCacheMetadata`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import torch

from liquid_tpu_torch.cache import policies as pol
from liquid_tpu_torch.cache import transcode as tc
from liquid_tpu_torch.cache.budget import BudgetAccounting
from liquid_tpu_torch.cache.expressions import HintVote
from liquid_tpu_torch.cache.observer import Observer
from liquid_tpu_torch.arrays.base import BLOCK_ROWS
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

    # -- predicate evaluation on the encodings ------------------------------

    @TRACER.trace("cache.eval_predicate")
    def eval_predicate(self, entry_id: int, pred):
        """A BoolMask of `pred` evaluated on the encoded entry, or None
        (the entry is absent, arrow, or has no encoded form for `pred`:
        the caller decodes and evaluates)."""
        obs = self.observer
        obs.stats.bump("predicate_evals")
        with self._lock:
            e = self._entries.get(entry_id)
        if e is None or e.state != MEMORY_LIQUID:
            return None
        out = e.payload.try_eval_predicate(pred, self.device)
        if out is not None:
            obs.stats.bump("predicate_evals_on_encoded")
        return out

    @TRACER.trace("cache.eval_predicate_many")
    def eval_predicate_many(self, entry_ids, pred):
        """Batched evaluation over many entries (a row group's blocks of
        one column): primitive blocks of one width bucket are stacked and
        compared in ONE launch (`bitpack.cmp_const_op_many`, K1 on the
        card), string blocks gather their dictionary verdicts in one
        call, the rest go one by one.  -> BoolMask | None per entry id."""
        from liquid_tpu_torch.arrays.base import validity_mask_or_full
        from liquid_tpu_torch.arrays.byteview import (
            LiquidByteViewArray, _verdict_gather_many)
        from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
        from liquid_tpu_torch.device import u64_to_i64, words_to_tensor
        from liquid_tpu_torch.ops import bitpack as bp
        from liquid_tpu_torch.ops import mask as mops
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
            if len(items) == 1:
                i, p, u = items[0]
                bits = bp.cmp_const_op(words_to_tensor(p.planes_np, dev),
                                       int(u), op)
                results[i] = mops.BoolMask(bits, validity_mask_or_full(
                    p.validity_np, p.length, dev))
                continue
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
        """Batched decode: primitive and float bit-plane blocks unpack in
        ONE call per width bucket and ONE fetch; the rest go through
        `get`.  -> pa.Array | None per entry id."""
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
