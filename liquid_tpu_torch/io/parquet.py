"""Parquet tables scanned through the cache (port of
`liquid_tpu/io/parquet.py`).

Entry ids pack `(file<<48)|(rowgroup<<32)|(column<<16)|batch`.  Batches
are 8192-row slices of a row group; a miss reads the column chunk once
and inserts every batch.  Row groups are pruned by their min/max
statistics, batches by min/max zone maps recorded on first load.  When
the cache refuses a block under memory pressure (its insert went to disk
or was dropped), the block is read straight from the parquet file.  The
reference also prunes with bloom filters and seeds zones from the page
index; those readers are not ported yet.
"""
from __future__ import annotations

import datetime
import threading
from typing import Dict, List, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from liquid_tpu_torch.arrays.base import BLOCK_ROWS, Predicate


def pack_id(file_id: int, rg: int, col: int, batch: int) -> int:
    assert file_id < (1 << 16) and rg < (1 << 16)
    assert col < (1 << 16) and batch < (1 << 16)
    return (file_id << 48) | (rg << 32) | (col << 16) | batch


_EPOCH = datetime.date(1970, 1, 1)


def _as_days(v):
    """date literals compare in the raw date32 domain (days)."""
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return (v - _EPOCH).days
    return v


def _may_match(op: str, v, lo, hi) -> bool:
    """False only when [lo, hi] proves no value can satisfy `x op v`."""
    try:
        if op == "eq":
            return not (v < lo or v > hi)
        if op == "lt":
            return lo < v
        if op == "lt_eq":
            return lo <= v
        if op == "gt":
            return hi > v
        if op == "gt_eq":
            return hi >= v
    except TypeError:
        pass  # incomparable bounds (e.g. bytes vs str)
    return True


class ParquetTable:
    """One registered parquet file, scanned through the cache."""

    def __init__(self, name: str, path: str, cache, file_id: int):
        self.name = name
        self.path = path
        self.cache = cache
        self.file_id = file_id
        self._pf = pq.ParquetFile(path)
        self.metadata = self._pf.metadata
        self.schema = self._pf.schema_arrow
        self.column_names = list(self.schema.names)
        self._col_index = {n: i for i, n in enumerate(self.column_names)}
        self._zones: Dict[tuple, tuple] = {}  # (rg, col, batch) -> bounds
        self.zone_prunes = 0  # batches skipped by zone maps
        self._lock = threading.Lock()

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows

    @property
    def num_row_groups(self) -> int:
        return self.metadata.num_row_groups

    def rg_num_rows(self, rg: int) -> int:
        return self.metadata.row_group(rg).num_rows

    def num_batches(self, rg: int) -> int:
        return (self.rg_num_rows(rg) + BLOCK_ROWS - 1) // BLOCK_ROWS

    def batch_length(self, rg: int, batch: int) -> int:
        return min(BLOCK_ROWS, self.rg_num_rows(rg) - batch * BLOCK_ROWS)

    def entry_id(self, rg: int, col_name: str, batch: int) -> int:
        return pack_id(self.file_id, rg, self._col_index[col_name], batch)

    def field(self, col_name: str) -> pa.Field:
        return self.schema.field(col_name)

    # -- row-group pruning by column-chunk statistics ------------------------

    def prune_row_groups(self, pushed: List[Tuple[str, Predicate]]
                         ) -> List[int]:
        """Row groups that may hold matching rows; `pushed` are AND-ed
        (column, predicate) pairs."""
        return [rg for rg in range(self.num_row_groups)
                if self._rg_may_match(rg, pushed)]

    def _rg_may_match(self, rg: int, pushed) -> bool:
        meta = self.metadata.row_group(rg)
        for col, pred in pushed:
            ci = self._col_index.get(col)
            if ci is None or pred.op == "ne":
                continue
            stats = meta.column(ci).statistics
            if stats is None or not stats.has_min_max:
                continue
            if not _may_match(pred.op, pred.literal, stats.min, stats.max):
                return False
        return True

    # -- batch-level zone maps (built once, on first load) -------------------

    def _record_zone(self, rg: int, col_name: str, batch: int,
                     chunk: pa.Array) -> None:
        t = chunk.type
        if not (pa.types.is_integer(t) or pa.types.is_floating(t)
                or pa.types.is_date(t) or pa.types.is_timestamp(t)):
            return
        mm = pc.min_max(chunk)
        lo, hi = mm["min"].as_py(), mm["max"].as_py()
        nan_free = True
        if pa.types.is_floating(t):
            # min_max skips NaN on mixed input, so the bounds alone cannot
            # prove NaN-absence; keep_nan predicates need the flag
            if isinstance(lo, float) and (lo != lo or hi != hi):
                return  # all-NaN: every comparison is False, no pruning
            nan_free = not pc.any(pc.is_nan(
                chunk.drop_null() if chunk.null_count else chunk)).as_py()
        lo, hi = _as_days(lo), _as_days(hi)
        if lo is not None and not isinstance(lo, datetime.datetime):
            self._zones[(rg, col_name, batch)] = (lo, hi, nan_free)

    def batch_may_match(self, rg: int, col_name: str, batch: int,
                        pred: Predicate) -> bool:
        """False only when the zone map PROVES no row of the batch can
        match `pred` (unknown zones always pass)."""
        z = self._zones.get((rg, col_name, batch))
        if z is None:
            return True
        lo, hi, nan_free = z
        if pred.keep_nan and not nan_free:
            return True
        if pred.op not in ("eq", "lt", "lt_eq", "gt", "gt_eq"):
            return True
        return _may_match(pred.op, _as_days(pred.literal), lo, hi)

    # -- column loading through the cache -------------------------------------

    def ensure_cached(self, rg: int, col_name: str, hint=None) -> List[int]:
        """Offer every batch of (rg, col) to the cache -> their entry ids.
        A batch the cache refuses (its insert returned False: on disk or
        dropped) is left as the cache has it."""
        ids = [self.entry_id(rg, col_name, b)
               for b in range(self.num_batches(rg))]
        if all(self.cache.contains(eid) for eid in ids):
            return ids
        with self._lock:
            if all(self.cache.contains(eid) for eid in ids):
                return ids
            data = self._pf.read_row_group(
                rg, columns=[col_name]).column(0).combine_chunks()
            for b, eid in enumerate(ids):
                chunk = data.slice(b * BLOCK_ROWS, BLOCK_ROWS)
                if (rg, col_name, b) not in self._zones:
                    self._record_zone(rg, col_name, b, chunk)
                if not self.cache.contains(eid):
                    self.cache.insert(eid, chunk, hint=hint)
        return ids

    def get_batch(self, rg: int, col_name: str, batch: int,
                  hint=None) -> pa.Array:
        """One decoded block of (rg, col) as arrow (dictionaries decoded)."""
        eid = self.entry_id(rg, col_name, batch)
        out = self.cache.get(eid)
        if out is None:
            self.ensure_cached(rg, col_name, hint)
            out = self.cache.get(eid)
            if out is None:  # refused under pressure: read the file
                out = self._pf.read_row_group(
                    rg, columns=[col_name]).column(0).combine_chunks(
                    ).slice(batch * BLOCK_ROWS, BLOCK_ROWS)
        if pa.types.is_dictionary(out.type):
            out = out.cast(out.type.value_type)
        return out

    def get_batches(self, rg: int, col_name: str, hint=None, batches=None):
        """The requested blocks of (rg, col) in one batched cache decode
        -> {batch: pa.Array}."""
        ids = self.ensure_cached(rg, col_name, hint)
        want = list(range(len(ids)) if batches is None else batches)
        out = {}
        for b, arr in zip(want, self.cache.get_arrow_many(
                [ids[b] for b in want])):
            if arr is None:  # refused under pressure: a direct read
                arr = self.get_batch(rg, col_name, b, hint)
            if pa.types.is_dictionary(arr.type):
                arr = arr.cast(arr.type.value_type)
            out[b] = arr
        return out

    def eval_predicate(self, rg: int, col_name: str, batch: int,
                       pred: Predicate, hint=None):
        ids = self.ensure_cached(rg, col_name, hint)
        return self.cache.eval_predicate(ids[batch], pred)

    def eval_predicate_many(self, rg: int, col_name: str, pred: Predicate,
                            hint=None, batches=None):
        """`pred` over the requested blocks of (rg, col) in one batched
        cache call -> {batch: BoolMask | None}."""
        ids = self.ensure_cached(rg, col_name, hint)
        want = list(range(len(ids)) if batches is None else batches)
        return dict(zip(want, self.cache.eval_predicate_many(
            [ids[b] for b in want], pred)))
