"""Parquet tables scanned through the cache (port of
`liquid_tpu/io/parquet.py`).

Entry ids pack `(file<<48)|(rowgroup<<32)|(column<<16)|batch`.  Batches
are 8192-row slices of a row group; a miss reads the column chunk once
and inserts every batch.  Row groups are pruned by their min/max
statistics, then, for an equality predicate that survives them, by the
column chunk's bloom filter (`io/bloom.py`, counted in `bloom_prunes`).
Batches are pruned by min/max zone maps: seeded from the file's page
index before any data IO (`io/pageindex.py`, counted in
`pageindex_seeds`), else recorded on first load.  A table may read its
file through an object store (`open_file`, e.g. a `StoreFile` over a
`ByteCache`).  When the cache refuses a block under memory pressure (its
insert went to disk or was dropped), the block is read straight from the
parquet file.  A column read only through `variant_get` (a `VariantGet`
hint) is read as a struct of the hint's typed paths: from a squeezed
variant entry (no IO when the paths are resident), else parsed from the
JSON block.
"""
from __future__ import annotations

import datetime
import decimal
import threading
from typing import Dict, List, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from liquid_tpu_torch.arrays.base import BLOCK_ROWS, Predicate
from liquid_tpu_torch.arrays.variant import extract_paths, parse_docs
from liquid_tpu_torch.cache.expressions import VariantGet
from liquid_tpu_torch.io.bloom import BloomReader
from liquid_tpu_torch.io.pageindex import PageIndexReader


def pack_id(file_id: int, rg: int, col: int, batch: int) -> int:
    assert file_id < (1 << 16) and rg < (1 << 16)
    assert col < (1 << 16) and batch < (1 << 16)
    return (file_id << 48) | (rg << 32) | (col << 16) | batch


def unpack_id(eid: int) -> Tuple[int, int, int, int]:
    """(file, row group, column, batch) of a packed entry id."""
    return ((eid >> 48) & 0xFFFF, (eid >> 32) & 0xFFFF, (eid >> 16) & 0xFFFF,
            eid & 0xFFFF)


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


def _stats_literal(t: pa.DataType, v):
    """`v` as it compares with `t`'s row-group statistics, or None (no
    pruning).  A decimal's statistics are `Decimal`s, and a float literal
    stands for the decimal it spells, as the decimal block reads it: 0.1
    is not above a max of 0.10.  NaN orders against no decimal."""
    if pa.types.is_decimal(t) and isinstance(v, float):
        return None if v != v else decimal.Decimal(str(v))
    return v


def _bloom_literal(t: pa.DataType, v):
    """`v` when a column of arrow type `t` hashes the literal's own plain
    encoding into its bloom filter, else None (no probe).  A decimal
    hashes its unscaled integer or fixed-length bytes, a float32 its
    4-byte value, an unsigned column its bit pattern; a float 0 has two
    encodings (+0, -0) that compare equal, and NaN equals nothing.  A
    probe with another encoding would prove a present value absent."""
    if v is None or isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v if pa.types.is_signed_integer(t) else None
    if isinstance(v, float):
        return v if pa.types.is_float64(t) and v == v and v != 0 else None
    if isinstance(v, str):
        return v if pa.types.is_string(t) or pa.types.is_large_string(t) \
            else None
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return v if pa.types.is_date32(t) else None
    return None


class ParquetTable:
    """One registered parquet file, scanned through the cache.

    `open_file` (optional) returns a fresh binary file-like of the file,
    to scan an object in a store (`common/object_store.StoreFile`)."""

    def __init__(self, name: str, path: str, cache, file_id: int,
                 open_file=None):
        self.name = name
        self.path = path
        self.cache = cache
        self.file_id = file_id
        self._pf = pq.ParquetFile(open_file() if open_file else path)
        self.metadata = self._pf.metadata
        self.schema = self._pf.schema_arrow
        self.column_names = list(self.schema.names)
        self._col_index = {n: i for i, n in enumerate(self.column_names)}
        self._zones: Dict[tuple, tuple] = {}  # (rg, col, batch) -> bounds
        self.zone_prunes = 0  # batches skipped by zone maps
        self.bloom_prunes = 0  # row groups skipped by bloom filters
        self.pageindex_seeds = 0  # columns whose zones came from the index
        self.pageindex_zones = 0  # batch zones set from the page index
        self._bloom = BloomReader(path, self.metadata, open_file)
        self._pageindex = PageIndexReader(path, open_file)
        self._pi_seeded: set = set()  # (rg, col) already seeded
        self._lock = threading.Lock()
        #: the fused routes' device state between queries, owned by
        #: `sql/fused_agg.TableState` (made by `fused_agg.table_state`)
        self.route_state = None

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
            lit = _stats_literal(self.schema.field(col).type, pred.literal)
            if lit is not None and not _may_match(pred.op, lit, stats.min,
                                                  stats.max):
                return False
        # min/max passed: an equality literal the column chunk's bloom
        # filter proves absent drops the row group
        for col, pred in pushed:
            ci = self._col_index.get(col)
            if ci is None or pred.op != "eq":
                continue
            lit = _bloom_literal(self.schema.field(col).type, pred.literal)
            if lit is None:
                continue
            phys = meta.column(ci).physical_type
            if self._bloom.might_contain(rg, ci, lit, phys) is False:
                self.bloom_prunes += 1
                return False
        return True

    # -- batch-level zone maps (from the page index, else on first load) -----

    def _seed_zones_from_pageindex(self, rg: int, col_name: str) -> None:
        """Zones of (rg, col)'s batches from the column index's page
        min/max, before any data IO.  A batch spanning several pages gets
        their merged range; a batch touching a page without stats stays
        unknown."""
        key = (rg, col_name)
        if key in self._pi_seeded:
            return
        self._pi_seeded.add(key)
        ci = self._col_index[col_name]
        phys = self.metadata.row_group(rg).column(ci).physical_type
        zones = self._pageindex.page_zones(rg, ci, phys, self.rg_num_rows(rg))
        if not zones:
            return
        t = self.schema.field(col_name).type
        if (pa.types.is_timestamp(t) or pa.types.is_date64(t)
                or pa.types.is_decimal(t)):
            # predicates on these arrive as datetimes, or in the decimal's
            # units where an integer-stored decimal's stats are unscaled
            return
        nulls = self._null_rows_upper(rg, ci)
        for b in range(self.num_batches(rg)):
            b_lo = b * BLOCK_ROWS
            b_hi = b_lo + self.batch_length(rg, b)
            lo = hi = None
            covered = 0
            for frow, end, plo, phi in zones:
                if end <= b_lo or frow >= b_hi:
                    continue
                covered += min(end, b_hi) - max(frow, b_lo)
                lo = plo if lo is None else min(lo, plo)
                hi = phi if hi is None else max(hi, phi)
            # trusted only when pages with stats cover every row of the
            # batch but its NULLs (which match no comparison); parquet
            # float stats exclude NaN, so they cannot prove NaN-absence
            if (lo is not None and covered >= b_hi - b_lo - nulls
                    and (rg, col_name, b) not in self._zones):
                self._zones[(rg, col_name, b)] = (
                    lo, hi, phys not in ("FLOAT", "DOUBLE"))
                self.pageindex_zones += 1
        self.pageindex_seeds += 1

    def _null_rows_upper(self, rg: int, ci: int) -> int:
        """NULL rows of the column chunk by its statistics (0 without)."""
        stats = self.metadata.row_group(rg).column(ci).statistics
        if stats is not None and stats.null_count is not None:
            return stats.null_count
        return 0

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
        if (rg, col_name) not in self._pi_seeded:
            self._seed_zones_from_pageindex(rg, col_name)
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
        """One decoded block of (rg, col) as arrow (dictionaries decoded).
        Under a VariantGet hint it is the struct of the hint's typed
        paths: read from a squeezed variant entry (no IO when they are
        resident), else parsed from the JSON block, so that every block
        of a scan has one type."""
        eid = self.entry_id(rg, col_name, batch)
        if isinstance(hint, VariantGet):
            if not self.cache.contains(eid):
                self.ensure_cached(rg, col_name, hint)
            out = self.cache.get_variant_paths(eid, hint.requests)
            if out is not None:
                return out
            return extract_paths(parse_docs(self.get_batch(rg, col_name,
                                                           batch)),
                                 hint.requests)
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
