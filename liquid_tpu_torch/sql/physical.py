"""Physical execution (port of `liquid_tpu/sql/physical.py`): the plan
helpers shared with the fused path (display names, aggregate discovery
and slotting, expression substitution, column collection) and the
classic scan -> filter -> aggregate path.

The classic scan (`scan_blocks`) walks a table's row groups.  Per
row group, each pushdown predicate is evaluated on the cached encodings
of every live block in one batched cache call (primitive blocks of one
width bucket in one K1 launch, `cache.eval_predicate_many`), blocks are
pruned by zone maps and by runtime filters (a top-k threshold, a join's
key bounds), residual expressions run on the decoded blocks, and the
surviving blocks' selections are fetched to the host in one transfer.
Selections are numpy words while every mask that made them came from
the host, and device words once an encoded mask joins.

The aggregators here are the pyarrow forms (`Table.group_by` partials
merged at the end); `sql/device_agg.py` holds the device forms and the
routing between them.  The port keeps no pandas: median partials fold
with pyarrow and numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.arrays.base import BLOCK_ROWS, Predicate
from liquid_tpu_torch.device import words_to_tensor
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.sql import ast

AGG_FUNCS = {"count", "sum", "avg", "min", "max", "median",
             "approx_distinct", "stddev", "var"}


def render(e: ast.Expr) -> str:
    """DataFusion-style display name for an unaliased expression."""
    if isinstance(e, ast.Column):
        return e.name
    if isinstance(e, ast.Literal):
        v = e.value
        return f"'{v}'" if isinstance(v, str) else str(v)
    if isinstance(e, ast.Func):
        if e.star:
            return f"{e.name}(*)"
        inner = ",".join(render(a) for a in e.args)
        d = "DISTINCT " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, ast.Binary):
        return f"{render(e.left)} {e.op} {render(e.right)}"
    if isinstance(e, ast.Unary):
        return f"{e.op} {render(e.operand)}"
    if isinstance(e, ast.Extract):
        return f"extract({e.field} from {render(e.operand)})"
    if isinstance(e, ast.Cast):
        return f"cast({render(e.operand)} as {e.type_name})"
    if isinstance(e, ast.WindowFunc):
        return f"{render(e.func)} over (...)"
    return type(e).__name__.lower()


def find_aggs(e: ast.Expr, out: List[ast.Func]) -> None:
    if isinstance(e, ast.WindowFunc):
        return  # window args are evaluated by the window stage, not here
    if isinstance(e, ast.Func) and e.name in AGG_FUNCS:
        if e not in out:
            out.append(e)
        return
    for f_ in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_)
        if isinstance(v, ast.Expr):
            find_aggs(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.Expr):
                    find_aggs(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Expr):
                            find_aggs(y, out)


def substitute(e: ast.Expr, mapping: Dict[ast.Expr, str]) -> ast.Expr:
    """Replace sub-expressions (structural equality) with column refs."""
    if e in mapping:
        return ast.Column(mapping[e])
    if isinstance(e, ast.Binary):
        return ast.Binary(e.op, substitute(e.left, mapping),
                          substitute(e.right, mapping))
    if isinstance(e, ast.Unary):
        return ast.Unary(e.op, substitute(e.operand, mapping))
    if isinstance(e, ast.Case):
        whens = tuple((substitute(c, mapping), substitute(v, mapping))
                      for c, v in e.whens)
        return ast.Case(whens,
                        substitute(e.else_, mapping) if e.else_ else None,
                        substitute(e.operand, mapping) if e.operand else None)
    if isinstance(e, ast.Cast):
        return ast.Cast(substitute(e.operand, mapping), e.type_name)
    if isinstance(e, ast.Extract):
        return ast.Extract(e.field, substitute(e.operand, mapping))
    if isinstance(e, ast.Func):
        return ast.Func(e.name, tuple(substitute(a, mapping) for a in e.args),
                        e.distinct, e.star)
    if isinstance(e, ast.Between):
        return ast.Between(substitute(e.operand, mapping),
                           substitute(e.low, mapping),
                           substitute(e.high, mapping), e.negated)
    if isinstance(e, ast.InList):
        return ast.InList(substitute(e.operand, mapping),
                          tuple(substitute(i, mapping) for i in e.items),
                          e.negated)
    if isinstance(e, ast.IsNull):
        return ast.IsNull(substitute(e.operand, mapping), e.negated)
    return e


def collect_columns(e, out: set) -> None:
    if isinstance(e, ast.Column):
        out.add(e.name)
        return
    for f_ in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_)
        if isinstance(v, ast.Expr):
            collect_columns(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.Expr):
                    collect_columns(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Expr):
                            collect_columns(y, out)


# -- the scan / filter loop ------------------------------------------------------

@dataclass
class ScanBlock:
    table: object          # ParquetTable
    rg: int
    batch: int
    length: int
    sel_idx: np.ndarray    # int64 indices of the surviving rows
    _cols: dict

    def col(self, name: str, hint=None) -> pa.Array:
        """The column under the selection."""
        return self.full_col(name, hint).take(pa.array(self.sel_idx,
                                                       pa.int64()))

    def full_col(self, name: str, hint=None) -> pa.Array:
        arr = self._cols.get(name)
        if arr is None:
            arr = self.table.get_batch(self.rg, name, self.batch, hint)
            self._cols[name] = arr
        return arr

    @property
    def num_selected(self) -> int:
        return len(self.sel_idx)


def scan_blocks(table, plan, hints: Dict[str, object],
                needed_cols: List[str], dynamic=None, subquery=None):
    """Yield ScanBlocks with the plan's selections applied.

    `dynamic`, when given, is a zero-argument callable returning the
    current [(column, Predicate)] runtime filters (a top-k threshold,
    join-key bounds).  It is read at every row group's start, so filters
    that tighten mid-query prune later row groups; they apply on the
    encodings only (no fallback), being conservative refinements of the
    static plan.  `subquery` is the evaluator's callback for a scalar
    subquery inside a residual."""
    from liquid_tpu_torch.sql.eval import Batch, Evaluator
    dev = table.cache.device

    def sel_and(a, b):
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return a & b
        return _words(a, dev) & _words(b, dev)

    def sel_counts(live_sels):
        if all(isinstance(x, np.ndarray) for x in live_sels):
            return np.array([mops.count_host(x) for x in live_sels])
        return mops.count_many(torch.stack([_words(x, dev)
                                            for x in live_sels])).cpu().numpy()

    may = table.batch_may_match
    for rg in table.prune_row_groups(plan.stats_preds):
        n_b = table.num_batches(rg)
        lengths = [table.batch_length(rg, b) for b in range(n_b)]
        sels = [mops.all_set_host(BLOCK_ROWS, lengths[b])
                for b in range(n_b)]
        alive = [True] * n_b
        deferred: List[List] = [[] for _ in range(n_b)]  # decoded-eval exprs

        for group in plan.pushdown:
            # zone maps: the whole OR group must provably miss the block
            for b in range(n_b):
                if alive[b] and all(not may(rg, col, b, pred)
                                    for col, pred in group.alternatives):
                    alive[b] = False
                    table.zone_prunes += 1
            live = [b for b in range(n_b) if alive[b]]
            if not live:
                break
            combined: Dict[int, object] = {}
            fallback = False
            for col, pred in group.alternatives:
                masks = table.eval_predicate_many(rg, col, pred,
                                                  hints.get(col),
                                                  batches=live)
                if any(masks.get(b) is None for b in live):
                    fallback = True
                    break
                for b in live:
                    bm = masks[b]
                    combined[b] = (bm if b not in combined
                                   else combined[b].or_kleene(bm))
            if fallback:
                for b in live:
                    deferred[b].append(group.source)
                continue
            for b in live:
                sels[b] = sel_and(sels[b], combined[b].to_selection())
            # one count fetch for the group across the live blocks
            counts = sel_counts([sels[b] for b in live])
            for j, b in enumerate(live):
                if counts[j] == 0:
                    alive[b] = False

        # runtime filters, read per row group
        for col, pred in (dynamic() if dynamic is not None else ()):
            live = [b for b in range(n_b) if alive[b]]
            if not live:
                break
            for b in live:
                if not may(rg, col, b, pred):
                    alive[b] = False
                    _bump_dynamic(table)
            live = [b for b in range(n_b) if alive[b]]
            if not live:
                break
            masks = table.eval_predicate_many(rg, col, pred, hints.get(col),
                                              batches=live)
            if any(masks.get(b) is None for b in live):
                continue  # encodings only
            for b in live:
                sels[b] = sel_and(sels[b], masks[b].to_selection())
            counts = sel_counts([sels[b] for b in live])
            for j, b in enumerate(live):
                if counts[j] == 0:
                    alive[b] = False
                    _bump_dynamic(table)

        survivors = [b for b in range(n_b) if alive[b]]
        if not survivors:
            continue
        # decode every surviving block of every column the projection and
        # the residuals touch: one batched cache decode per column
        mats: Dict[int, dict] = {b: {} for b in survivors}
        prefetch: set = set(needed_cols)
        for b in survivors:
            for conj in deferred[b] + plan.residual:
                collect_columns(conj, prefetch)
        for c in sorted(prefetch & set(table.column_names)):
            for b, arr in table.get_batches(rg, c, hints.get(c),
                                            batches=survivors).items():
                mats[b][c] = arr

        touched = {b: bool(plan.pushdown) for b in survivors}
        final: List[Tuple[int, object]] = []
        for b in survivors:
            sel = sels[b]
            cols_cache = mats[b]
            for conj in deferred[b] + plan.residual:
                cols: set = set()
                collect_columns(conj, cols)
                # a decorrelated lookup names inner-table and __outer
                # columns, which are not the scan's
                cols &= set(table.column_names)
                batch = Batch({c: _full(table, rg, b, c, cols_cache, hints)
                               for c in cols}, lengths[b])
                m = Evaluator(batch, subquery).arr(conj)
                sel = sel_and(sel, _bool_to_packed(m, lengths[b]))
                touched[b] = True
            final.append((b, sel))
        # an untouched selection is known; host words unpack on the host;
        # the device words of the row group come back in one transfer
        fetched = [b for b, x in final
                   if touched[b] and not isinstance(x, np.ndarray)]
        if fetched:
            fset = set(fetched)
            stacked = torch.stack([x for b, x in final if b in fset])
            allbits = mops.unpack_bits(stacked).cpu().numpy()
            row = {b: j for j, b in enumerate(fetched)}
        for b, x in final:
            if not touched[b]:
                idx = np.arange(lengths[b], dtype=np.int64)
            else:
                bits = (mops.unpack_bits_host(x) if isinstance(x, np.ndarray)
                        else allbits[row[b]])
                idx = np.flatnonzero(bits[:lengths[b]])
                if idx.size == 0:
                    continue
            yield ScanBlock(table, rg, b, lengths[b], idx, mats.get(b, {}))


def _words(x, dev) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else words_to_tensor(x, dev)


class TopKTracker:
    """A running ORDER BY col LIMIT k threshold.  Once k non-null keys
    were seen, `current()` publishes a non-strict threshold predicate
    (ties kept): rows strictly worse than the k-th best can never reach
    the top k, so later blocks and row groups prune them."""

    def __init__(self, col: str, desc: bool, k: int, typ: pa.DataType):
        self.col = col
        self.desc = desc
        self.k = k
        self._vals = np.empty(0, np.float64 if pa.types.is_floating(typ)
                              else np.int64)

    def update(self, arr: pa.Array) -> None:
        arr = _dedict(arr)
        if arr.null_count:
            arr = arr.drop_null()
        if len(arr) == 0:
            return
        if pa.types.is_date32(arr.type):
            v = np.asarray(arr.cast(pa.int32())).astype(np.int64)
        elif pa.types.is_floating(arr.type):
            v = np.asarray(arr.cast(pa.float64()))
            # NaN sorts greatest.  DESC: NaN rows hold top-k places, so
            # they count as +inf (the predicate keeps NaN).  ASC: a
            # threshold needs k non-NaN values, so NaN never reaches it.
            if self.desc:
                v = np.where(np.isnan(v), np.inf, v)
            else:
                v = v[~np.isnan(v)]
                if v.size == 0:
                    return
        else:
            v = np.asarray(arr.cast(pa.int64(), safe=False))
        self._vals = np.concatenate([self._vals, v.astype(self._vals.dtype)])
        if len(self._vals) > 4 * self.k:
            self._shrink()

    def _shrink(self) -> None:
        k = self.k
        if self.desc:
            self._vals = np.partition(self._vals,
                                      len(self._vals) - k)[len(self._vals) - k:]
        else:
            self._vals = np.partition(self._vals, k - 1)[:k]

    def current(self):
        if len(self._vals) < self.k:
            return ()
        self._shrink()
        if self.desc:
            thresh, op = self._vals.min(), "gt_eq"
        else:
            thresh, op = self._vals.max(), "lt_eq"
        if self._vals.dtype == np.float64:
            # DESC: NaN rows must survive (they sort greatest); an all-NaN
            # top k clamps to the largest finite f64
            lit = float(np.finfo(np.float64).max) if np.isinf(thresh) \
                else float(thresh)
            return ((self.col, Predicate(op, lit, keep_nan=self.desc)),)
        return ((self.col, Predicate(op, int(thresh))),)


def _bump_dynamic(table) -> None:
    """Count a block skipped by a runtime filter."""
    table.cache.observer.stats.bump("dynamic_filter_prunes")


def _full(table, rg, b, col, cache_dict, hints):
    arr = cache_dict.get(col)
    if arr is None:
        arr = table.get_batch(rg, col, b, hints.get(col))
        cache_dict[col] = arr
    return arr


def _bool_to_packed(m: pa.Array, length: int) -> np.ndarray:
    """pyarrow bool mask -> packed uint32 words on the host (the mask was
    made on the host: no device round trip)."""
    vals = np.zeros(BLOCK_ROWS, dtype=bool)
    vals[:length] = np.asarray(m.fill_null(False).cast(pa.bool_()))[:length]
    return mops.pack_bools_host(vals)


# -- aggregate execution -------------------------------------------------------

@dataclass
class AggSlot:
    func: ast.Func
    name: str          # output column name
    kind: str          # count_star | count | count_distinct | sum | avg | min | max
    input: Optional[ast.Expr]


def make_slots(aggs: List[ast.Func]) -> List[AggSlot]:
    slots = []
    for i, f in enumerate(aggs):
        nm = f"__agg{i}"
        if f.name == "count" and (f.star or not f.args):
            slots.append(AggSlot(f, nm, "count_star", None))
        elif f.name == "count" and f.distinct:
            slots.append(AggSlot(f, nm, "count_distinct", f.args[0]))
        elif f.name == "count":
            slots.append(AggSlot(f, nm, "count", f.args[0]))
        elif f.name in ("sum", "avg", "min", "max"):
            assert not f.distinct, f"{f.name} DISTINCT unsupported"
            slots.append(AggSlot(f, nm, f.name, f.args[0]))
        elif f.name in ("stddev", "var"):
            # Welford-free two-pass form: (count, sum, sum of squares)
            # merged across partials; sample variance (DataFusion default)
            slots.append(AggSlot(f, nm, f.name, f.args[0]))
        elif f.name == "median":
            slots.append(AggSlot(f, nm, "median", f.args[0]))
        elif f.name == "approx_distinct":
            # exact distinct count (a strict refinement of the reference's
            # HLL-based approx_distinct)
            slots.append(AggSlot(f, nm, "count_distinct", f.args[0]))
        else:
            raise NotImplementedError(f"aggregate {f.name}")
    return slots


class GroupedAggregator:
    """Per-chunk partial aggregation with pyarrow `group_by`, merged at
    finalize (count -> sum, sum -> sum, min -> min, max -> max, avg ->
    (sum, count)); count(DISTINCT) and median keep (keys, value) partials."""

    def __init__(self, key_names: List[str], slots: List[AggSlot]):
        self.key_names = key_names
        self.slots = slots
        self._partials: List[pa.Table] = []
        self._distinct_partials: Dict[str, List[pa.Table]] = {
            s.name: [] for s in slots if s.kind == "count_distinct"}
        self._median_partials: Dict[str, List[pa.Table]] = {
            s.name: [] for s in slots if s.kind == "median"}
        self._key_types: Optional[List[pa.DataType]] = None
        self._input_types: Dict[str, pa.DataType] = {}

    def update(self, keys: List[pa.Array], inputs: Dict[str, pa.Array],
               n_rows: int) -> None:
        cols = {nm: _dedict(arr) for nm, arr in zip(self.key_names, keys)}
        if self._key_types is None:
            self._key_types = [cols[nm].type for nm in self.key_names]
        aggs = []
        for s in self.slots:
            if s.kind == "count_star":
                cols[s.name] = pa.array(np.ones(n_rows, np.int64))
                aggs.append((s.name, "sum"))
            elif s.kind == "count":
                cols[s.name] = inputs[s.name]
                aggs.append((s.name, "count"))
            elif s.kind == "sum":
                cols[s.name] = _sum_cast(inputs[s.name])
                aggs.append((s.name, "sum"))
            elif s.kind == "avg":
                # the average sums in f64 for every input type
                cols[s.name + "__s"] = _f64(inputs[s.name])
                cols[s.name + "__c"] = inputs[s.name]
                aggs += [(s.name + "__s", "sum"), (s.name + "__c", "count")]
            elif s.kind in ("min", "max"):
                cols[s.name] = _dedict(inputs[s.name])
                aggs.append((s.name, s.kind))
            elif s.kind in ("stddev", "var"):
                x = _f64(inputs[s.name])
                cols[s.name + "__s"] = x
                cols[s.name + "__q"] = pc.multiply(x, x)
                cols[s.name + "__c"] = inputs[s.name]
                aggs += [(s.name + "__s", "sum"), (s.name + "__q", "sum"),
                         (s.name + "__c", "count")]
            if s.input is not None and s.name in inputs:
                self._input_types.setdefault(s.name,
                                             _dedict(inputs[s.name]).type)
        if aggs:
            part = pa.table(cols).group_by(
                self.key_names, use_threads=False).aggregate(aggs)
            # pyarrow suffixes outputs with _<fn>: rename back
            suffix = {f"{c}_{fn}": c for c, fn in aggs}
            self._partials.append(part.rename_columns(
                [suffix.get(n, n) for n in part.column_names]))
        elif self.key_names and not self._distinct_only_slots():
            self._partials.append(pa.table(cols).group_by(
                self.key_names, use_threads=False).aggregate([]))
        for s in self.slots:
            if s.kind not in ("median", "count_distinct"):
                continue
            vcols = {nm: _dedict(a) for nm, a in zip(self.key_names, keys)}
            if s.kind == "median":
                vcols["__v"] = _f64(inputs[s.name])
                self._median_partials[s.name].append(pa.table(vcols))
                continue
            # distinct streams: per-chunk dedup of (keys, value)
            vcols["__v"] = _dedict(inputs[s.name])
            self._distinct_partials[s.name].append(pa.table(vcols).group_by(
                self.key_names + ["__v"], use_threads=False).aggregate([]))

    def _distinct_only_slots(self) -> bool:
        return bool(self.slots) and all(
            s.kind in ("count_distinct", "median") for s in self.slots)

    def _empty_typed(self) -> pa.Table:
        """Zero-row result with the right schema (no block matched)."""
        cols = {}
        kts = self._key_types or [pa.null()] * len(self.key_names)
        for nm, t in zip(self.key_names, kts):
            cols[nm] = pa.array([], t)
        for s in self.slots:
            if s.kind in ("count_star", "count", "count_distinct"):
                cols[s.name] = pa.array([], pa.int64())
            elif s.kind == "avg":
                cols[s.name + "__s"] = pa.array([], pa.float64())
                cols[s.name + "__c"] = pa.array([], pa.int64())
            elif s.kind in ("stddev", "var"):
                for suf, t in (("__s", pa.float64()), ("__q", pa.float64()),
                               ("__c", pa.int64())):
                    cols[s.name + suf] = pa.array([], t)
            elif s.kind == "median":
                cols[s.name] = pa.array([], pa.float64())
            else:
                t = self._input_types.get(s.name, pa.null())
                cols[s.name] = pa.array([], _sum_type(t) if s.kind == "sum"
                                        else t)
        return pa.table(cols)

    def _attach(self, out, part):
        """Join a per-key partial result onto `out` (None: it is `out`)."""
        if out is None:
            return part
        if part is None:
            return out
        if self.key_names:
            return out.join(part, keys=self.key_names,
                            join_type="full outer")
        for n in part.column_names:
            out = out.append_column(n, part.column(n))
        return out

    def finalize(self) -> pa.Table:
        merge_aggs, rename = [], {}
        for s in self.slots:
            if s.kind in ("count_star", "count", "sum"):
                merge_aggs.append((s.name, "sum"))
                rename[s.name + "_sum"] = s.name
            elif s.kind == "avg":
                for suf in ("__s", "__c"):
                    merge_aggs.append((s.name + suf, "sum"))
                    rename[s.name + suf + "_sum"] = s.name + suf
            elif s.kind in ("min", "max"):
                merge_aggs.append((s.name, s.kind))
                rename[f"{s.name}_{s.kind}"] = s.name
            elif s.kind in ("stddev", "var"):
                for suf in ("__s", "__q", "__c"):
                    merge_aggs.append((s.name + suf, "sum"))
                    rename[s.name + suf + "_sum"] = s.name + suf
        if self._partials:
            merged = pa.concat_tables(self._partials,
                                      promote_options="permissive")
            out = merged.group_by(self.key_names, use_threads=False) \
                .aggregate(merge_aggs)
            out = out.rename_columns([rename.get(n, n)
                                      for n in out.column_names])
        elif not self._distinct_only_slots():
            out = self._empty_typed()
        else:
            out = None
        for s in self.slots:
            if s.kind != "count_distinct":
                continue
            parts = self._distinct_partials[s.name]
            if not parts and out is None:
                out = self._empty_typed()
            dfin = None
            if parts:
                dfin = pa.concat_tables(
                    parts, promote_options="permissive").group_by(
                        self.key_names, use_threads=False).aggregate(
                            [("__v", "count_distinct")])
                dfin = dfin.rename_columns(
                    [s.name if n == "__v_count_distinct" else n
                     for n in dfin.column_names])
            out = self._attach(out, dfin)
        for s in self.slots:
            if s.kind != "median":
                continue
            parts = self._median_partials[s.name]
            if not parts and out is None:
                out = self._empty_typed()
            out = self._attach(out, _median_fold(
                parts, self.key_names, s.name) if parts else None)
        if out is None:
            out = pa.table({})
        cols = {n: out.column(n).combine_chunks() for n in out.column_names}
        for s in self.slots:
            if s.kind == "avg":
                ssum = cols.pop(s.name + "__s")
                scnt = cols.pop(s.name + "__c")
                cols[s.name] = pc.divide(ssum.cast(pa.float64()),
                                         scnt.cast(pa.float64()))
            elif s.kind in ("stddev", "var"):
                ss = cols.pop(s.name + "__s").cast(pa.float64())
                qq = cols.pop(s.name + "__q").cast(pa.float64())
                cc = cols.pop(s.name + "__c").cast(pa.float64())
                # sample variance: (sumsq - sum^2 / n) / (n - 1)
                num = pc.subtract(qq, pc.divide(pc.multiply(ss, ss), cc))
                var = pc.if_else(pc.greater(cc, 1.0),
                                 pc.divide(num, pc.subtract(cc, 1.0)),
                                 pa.scalar(None, pa.float64()))
                var = pc.max_element_wise(var, pa.scalar(0.0))
                cols[s.name] = pc.sqrt(var) if s.kind == "stddev" else var
            elif s.kind in ("count", "count_star", "count_distinct") \
                    and s.name in cols:
                cols[s.name] = pc.fill_null(cols[s.name].cast(pa.int64()), 0)
        return pa.table(cols) if cols else pa.table({})


def _median_fold(parts: List[pa.Table], key_names: List[str],
                 name: str) -> pa.Table:
    """Per-key median of the `__v` partials (NULL and NaN values skipped,
    NULL keys a group of their own): pyarrow gathers each group's values
    as a list, numpy sorts them by (group, value) and takes each group's
    midpoint."""
    t = pa.concat_tables(parts, promote_options="permissive")
    if not key_names:
        v = np.asarray(t["__v"].to_numpy(zero_copy_only=False), np.float64)
        v = v[~np.isnan(v)]
        return pa.table({name: pa.array(
            [float(np.median(v)) if v.size else None], pa.float64())})
    g = t.group_by(key_names, use_threads=False).aggregate(
        [("__v", "list")])
    lists = g["__v_list"].combine_chunks()
    gid = np.repeat(np.arange(len(lists)), np.diff(np.asarray(lists.offsets)))
    v = np.asarray(lists.values.to_numpy(zero_copy_only=False), np.float64)
    keep = ~np.isnan(v)  # NULLs read as NaN here
    gid, v = gid[keep], v[keep]
    order = np.lexsort((v, gid))
    v = v[order]
    sizes = np.bincount(gid, minlength=len(lists))
    starts = np.cumsum(sizes) - sizes
    lo = v[np.minimum(starts + (sizes - 1) // 2, max(len(v) - 1, 0))] \
        if len(v) else np.zeros(len(lists))
    hi = v[np.minimum(starts + sizes // 2, max(len(v) - 1, 0))] \
        if len(v) else np.zeros(len(lists))
    cols = {k: g.column(k) for k in key_names}
    cols[name] = pa.array((lo + hi) / 2.0, pa.float64(), mask=sizes == 0)
    return pa.table(cols)


class ScalarAggregator:
    """No GROUP BY: global accumulators (one row)."""

    def __init__(self, slots: List[AggSlot]):
        self.slots = slots
        self.state: Dict[str, object] = {}
        for s in slots:
            if s.kind in ("count_star", "count"):
                self.state[s.name] = 0
            elif s.kind == "count_distinct":
                self.state[s.name] = set()
            elif s.kind == "avg":
                self.state[s.name] = [None, 0]
            elif s.kind in ("stddev", "var"):
                self.state[s.name] = [0.0, 0.0, 0]  # sum, sumsq, count
            elif s.kind == "median":
                self.state[s.name] = []
            else:
                self.state[s.name] = None

    def update(self, inputs: Dict[str, pa.Array], n_rows: int) -> None:
        for s in self.slots:
            if s.kind == "count_star":
                self.state[s.name] += n_rows
                continue
            arr = inputs[s.name]
            st = self.state[s.name]
            if s.kind == "count":
                self.state[s.name] += len(arr) - arr.null_count
            elif s.kind == "count_distinct":
                st.update(x for x in _dedict(arr).to_pylist()
                          if x is not None)
            elif s.kind == "sum":
                v = pc.sum(_sum_cast(arr)).as_py()
                if v is not None:
                    self.state[s.name] = v if st is None else st + v
            elif s.kind == "avg":
                v = pc.sum(_f64(arr)).as_py()
                if v is not None:
                    st[0] = v if st[0] is None else st[0] + v
                st[1] += len(arr) - arr.null_count
            elif s.kind in ("min", "max"):
                v = (pc.min if s.kind == "min" else pc.max)(
                    _dedict(arr)).as_py()
                if v is not None:
                    self.state[s.name] = v if st is None else (
                        min(st, v) if s.kind == "min" else max(st, v))
            elif s.kind in ("stddev", "var"):
                x = _f64(arr)
                st[0] += pc.sum(x).as_py() or 0.0
                st[1] += pc.sum(pc.multiply(x, x)).as_py() or 0.0
                st[2] += len(arr) - arr.null_count
            elif s.kind == "median":
                st.extend(x for x in _f64(arr).to_pylist() if x is not None)

    def finalize(self, input_types: Dict[str, pa.DataType]) -> pa.Table:
        cols = {}
        for s in self.slots:
            st = self.state[s.name]
            if s.kind in ("count_star", "count"):
                cols[s.name] = pa.array([st], pa.int64())
            elif s.kind == "count_distinct":
                cols[s.name] = pa.array([len(st)], pa.int64())
            elif s.kind == "avg":
                v = (None if st[0] is None or st[1] == 0
                     else float(st[0]) / float(st[1]))
                cols[s.name] = pa.array([v], pa.float64())
            elif s.kind == "sum":
                t = input_types.get(s.name)
                cols[s.name] = pa.array([st], _sum_type(t) if t is not None
                                        else None)
            elif s.kind in ("stddev", "var"):
                ssum, ssq, n = st
                v = None
                if n > 1:
                    var = max((ssq - ssum * ssum / n) / (n - 1), 0.0)
                    v = var ** 0.5 if s.kind == "stddev" else var
                cols[s.name] = pa.array([v], pa.float64())
            elif s.kind == "median":
                cols[s.name] = pa.array([float(np.median(st)) if st else None],
                                        pa.float64())
            else:
                cols[s.name] = pa.array([st], input_types.get(s.name))
        return pa.table(cols)


def _dedict(arr: pa.Array) -> pa.Array:
    if pa.types.is_dictionary(arr.type):
        return arr.cast(arr.type.value_type)
    return arr


def _sum_type(t: pa.DataType) -> pa.DataType:
    if pa.types.is_floating(t):
        return pa.float64()
    if pa.types.is_unsigned_integer(t):
        return pa.uint64()
    if pa.types.is_integer(t):
        return pa.int64()
    return t


def _sum_cast(arr: pa.Array) -> pa.Array:
    arr = _dedict(arr)
    return arr.cast(_sum_type(arr.type))


def _f64(arr: pa.Array) -> pa.Array:
    # unchecked: int64 -> f64 loses low bits by design (each input value
    # is cast to f64 before it is added)
    return pc.cast(_dedict(arr), pa.float64(), safe=False)
