"""Query executor (port of `liquid_tpu/sql/exec.py`, aggregate routing).

SQL -> parse -> qualify -> plan -> fused device aggregate -> pa.Table.
A single-table aggregate, with or without GROUP BY, goes to the fused
path (`sql/fused_agg.py`); a COUNT(*) with no filter and no keys is
answered from parquet metadata, as the reference does.  count(DISTINCT)
takes a device route first (`distinct_fused_device`: sorted pairs or the
chained two-level hash), else the host fold (`distinct_two_level`).  An
aggregate over `FROM a, b, ...` or `a JOIN b ON ...` (inner or cross)
goes to the fused star path (`sql/fused_star.py`), count(DISTINCT) there
through the host fold.  The projection, HAVING and ORDER BY / LIMIT then
run over the small aggregate result with the host evaluator
(`sql/eval.py`).  A bare SELECT over one parquet table goes to the fused
select (`fused_agg.try_fused_select`).  Every other statement shape --
outer joins, derived tables, grouping sets, other plain SELECTs, set
operations, CTEs, windows, subqueries -- belongs to slices of the port
that are not done yet and raises NotImplementedError naming the shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.eval import Batch, Evaluator
from liquid_tpu_torch.sql.parser import parse_statement
from liquid_tpu_torch.sql.physical import (
    collect_columns, find_aggs, make_slots, render, substitute,
)
from liquid_tpu_torch.sql.planner import column_hints, plan_scan_filters
from liquid_tpu_torch.sql.qualify import Qualifier
from liquid_tpu_torch.utils.tracing import TRACER


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


def _contains(e, types) -> bool:
    """Does the expression tree hold a node of one of `types`?"""
    if isinstance(e, types):
        return True
    for f_ in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_)
        items = v if isinstance(v, (list, tuple)) else (v,)
        for x in items:
            for y in (x if isinstance(x, tuple) else (x,)):
                if isinstance(y, ast.Expr) and _contains(y, types):
                    return True
    return False


_SUBQUERY = (ast.Subquery, ast.InSubquery, ast.Exists)


def _extend(result: pa.Table, internal: pa.Table) -> pa.Table:
    cols = {n: result.column(n) for n in result.column_names}
    for n in internal.column_names:
        if n not in cols:
            cols[n] = internal.column(n)
    return pa.table(cols)


class QueryExecutor:
    def __init__(self, catalog: Dict[str, object], device="cpu"):
        self.catalog = catalog       # name -> ParquetTable
        self.device = device         # where the engine's tensors live

    def _base_columns(self, name: str):
        if name in self.catalog:
            return list(self.catalog[name].column_names)
        return None

    def execute_sql(self, sql: str) -> pa.Table:
        with TRACER.span("sql.execute", sql=sql[:120]):
            stmt = parse_statement(sql)
            if stmt[0] != "select":
                raise _not_ported(f"statement {stmt[0]!r}")
            q = stmt[1]
            if isinstance(q, ast.SetOp):
                raise _not_ported("UNION / INTERSECT / EXCEPT")
            if q.ctes:
                raise _not_ported("WITH (CTE)")
            return self.execute(Qualifier(self._base_columns).qualify(q))

    def execute(self, q: ast.Select) -> pa.Table:
        if q.from_ is None:
            raise _not_ported("SELECT without FROM")
        if any(_contains(e, ast.WindowFunc) for e in
               [it.expr for it in q.items] + [o.expr for o in q.order_by]):
            raise _not_ported("window functions")
        aggs: List[ast.Func] = []
        for it in q.items:
            find_aggs(it.expr, aggs)
        if q.having is not None:
            find_aggs(q.having, aggs)
        for o in q.order_by:
            find_aggs(o.expr, aggs)
        if not (aggs or q.group_by):
            return self._exec_plain(q)
        return self._exec_aggregate(q, aggs)

    def _exec_plain(self, q: ast.Select) -> pa.Table:
        """A bare SELECT: the fused select over one parquet table."""
        rel = q.from_
        if not (isinstance(rel, ast.TableRef) and not rel.prefix
                and rel.name in self.catalog):
            raise _not_ported("SELECT without aggregates (the classic path)")
        if q.where is not None and _contains(q.where, _SUBQUERY):
            raise _not_ported("subqueries")
        from liquid_tpu_torch.sql.fused_agg import try_fused_select
        with TRACER.span("sql.fused_select"):
            return try_fused_select(self, self.catalog[rel.name], q, q.where)

    def _resolve_group_exprs(self, q: ast.Select
                             ) -> List[Tuple[ast.Expr, str]]:
        """(key expression, output name) per GROUP BY item: ordinals and
        aliases resolve to their select items."""
        alias_map = {it.alias: it.expr for it in q.items if it.alias}
        out = []
        for g in q.group_by:
            if isinstance(g, ast.Literal) and isinstance(g.value, int):
                it = q.items[g.value - 1]
                out.append((it.expr, it.alias or render(it.expr)))
                continue
            if isinstance(g, ast.Column) and g.name in alias_map:
                out.append((alias_map[g.name], g.name))
                continue
            name = None
            for it in q.items:
                if it.expr == g:
                    name = it.alias or render(it.expr)
                    break
            out.append((g, name or render(g)))
        return out

    def _exec_aggregate(self, q: ast.Select,
                        aggs: List[ast.Func]) -> pa.Table:
        rel = q.from_
        star = isinstance(rel, ast.Join)
        if not star and not (isinstance(rel, ast.TableRef) and not rel.prefix
                             and rel.name in self.catalog):
            raise _not_ported("an aggregate over a derived or aliased table")
        if any(isinstance(g, ast.GroupingSpec) for g in q.group_by):
            raise _not_ported("GROUPING SETS / ROLLUP / CUBE")
        # a star join's WHERE subqueries reach its planner, which names
        # them (existence probes)
        exprs = [it.expr for it in q.items] + list(q.group_by) + [
            e for e in (None if star else q.where, q.having) if e is not None]
        if any(_contains(e, _SUBQUERY) for e in exprs):
            raise _not_ported("subqueries")
        slots = make_slots(aggs)
        group = self._resolve_group_exprs(q)
        key_names = [nm for _, nm in group]
        rew_keys = [ge for ge, _ in group]
        rew_inputs = {s.name: s.input for s in slots if s.input is not None}
        if star:
            from liquid_tpu_torch.sql.fused_agg import distinct_two_level
            from liquid_tpu_torch.sql.fused_star import try_fused_star
            # the inner aggregate of the fold is not the query: its ORDER
            # BY, LIMIT and HAVING must not cut the inner rows
            inner_q = dataclasses.replace(q, order_by=[], limit=None,
                                          offset=None, having=None)

            def run_star(g2, kn2, s2, rk2, ri2):
                return try_fused_star(self, inner_q, g2, kn2, s2, rk2, ri2,
                                      q.where)

            with TRACER.span("sql.fused_star"):
                final = distinct_two_level(slots, group, key_names, rew_keys,
                                           rew_inputs, run_star)
                if final is None:
                    final = try_fused_star(self, q, group, key_names, slots,
                                           rew_keys, rew_inputs, q.where)
            return self._project(q, group, slots, final)
        table = self.catalog[rel.name]
        plan = plan_scan_filters(q.where)
        needed: set = set()
        for ge in rew_keys:
            collect_columns(ge, needed)
        for s in slots:
            if s.input is not None:
                collect_columns(s.input, needed)
        pure_count = (not needed and not group
                      and all(s.kind == "count_star" for s in slots)
                      and not plan.pushdown and not plan.residual)
        if pure_count:
            # COUNT(*) without a filter: parquet metadata only
            final = pa.table({s.name: pa.array([table.num_rows], pa.int64())
                              for s in slots})
        else:
            from liquid_tpu_torch.sql import fused_agg
            hints = column_hints(q)
            final = None
            if any(s.kind == "count_distinct" for s in slots):
                with TRACER.span("sql.fused_distinct"):
                    # the device routes first; a failure there raises
                    final = fused_agg.distinct_fused_device(
                        table, plan, hints, group, key_names, slots,
                        rew_keys, rew_inputs, q)
                    if final is None:
                        final = fused_agg.distinct_two_level(
                            slots, group, key_names, rew_keys, rew_inputs,
                            lambda g2, kn2, s2, rk2, ri2:
                            fused_agg.try_fused_aggregate(
                                table, plan, hints, g2, kn2, s2, rk2, ri2))
            if final is None:
                with TRACER.span("sql.fused_aggregate"):
                    final = fused_agg.try_fused_aggregate(
                        table, plan, hints, group, key_names, slots,
                        rew_keys, rew_inputs, q)
        return self._project(q, group, slots, final)

    def _project(self, q: ast.Select, group, slots,
                 final: pa.Table) -> pa.Table:
        """The select items, HAVING and ORDER BY / LIMIT over the partial
        aggregate result (key columns + slot columns)."""
        mapping: Dict[ast.Expr, str] = {ge: nm for ge, nm in group}
        for s in slots:
            mapping[s.func] = s.name
        batch = Batch.from_table(final)
        ev = Evaluator(batch)
        out_cols: Dict[str, pa.Array] = {}
        for it in q.items:
            arr = ev.eval(substitute(it.expr, mapping))
            if isinstance(arr, pa.Scalar):
                arr = pa.repeat(arr, batch.length)
            out_cols[it.alias or render(it.expr)] = arr
        result = pa.table(out_cols)

        if q.having is not None:
            hb = Batch.from_table(_extend(result, final))
            m = Evaluator(hb).arr(substitute(q.having, mapping))
            keep = pc.fill_null(m.cast(pa.bool_()), False)
            result = result.filter(keep)
            final = final.filter(keep)
        return self._order_limit(q, result, final, mapping)

    def _order_limit(self, q: ast.Select, result: pa.Table,
                     internal: Optional[pa.Table], mapping) -> pa.Table:
        if q.order_by and result.num_rows:
            ns = _extend(result, internal) if internal is not None else result
            batch = Batch.from_table(ns)
            alias_map = {ast.Column(it.alias): it.alias for it in q.items
                         if it.alias and it.alias in ns.column_names}
            # an ORDER BY expr that IS a select item evaluates against the
            # projected table, under the item's output name
            item_map = {it.expr: (it.alias or render(it.expr))
                        for it in q.items
                        if not isinstance(it.expr, ast.Star)
                        and (it.alias or render(it.expr)) in ns.column_names}
            alias_map = {**item_map, **alias_map}
            sort_arrays = []
            for o in q.order_by:
                e = o.expr
                if isinstance(e, ast.Literal) and isinstance(e.value, int):
                    arr = result.column(
                        result.column_names[e.value - 1]).combine_chunks()
                else:
                    sub = substitute(e, {**(mapping or {}), **alias_map})
                    arr = Evaluator(batch).arr(sub)
                sort_arrays.append(arr)
            # per-key NULL placement: NULLS LAST for ASC, FIRST for DESC
            # unless stated
            placements = [o.desc if o.nulls_first is None else o.nulls_first
                          for o in q.order_by]
            from liquid_tpu_torch.sql.device_sort import try_sort_indices
            lim = (q.limit + (q.offset or 0)) if q.limit is not None else None
            idx = try_sort_indices(
                sort_arrays,
                [(o.desc, nf) for o, nf in zip(q.order_by, placements)],
                limit=lim, device=self.device)
            if idx is not None:
                result = result.take(pa.array(idx, pa.int64()))
            else:  # the host sorts (an accelerator, or a key type)
                # per-key NULL placement rides as a leading flag key:
                # older pyarrow takes no per-key placement in sort_keys
                cols, keys = {}, []
                for i, (a, o, nf) in enumerate(zip(sort_arrays, q.order_by,
                                                   placements)):
                    isnull = pc.is_null(a)
                    cols[f"__n{i}"] = pc.invert(isnull) if nf else isnull
                    cols[f"__s{i}"] = a
                    keys += [(f"__n{i}", "ascending"),
                             (f"__s{i}", "descending" if o.desc
                              else "ascending")]
                result = result.take(pc.sort_indices(pa.table(cols),
                                                     sort_keys=keys))
        if q.offset:
            result = result.slice(q.offset)
        if q.limit is not None:
            result = result.slice(0, q.limit)
        return result
