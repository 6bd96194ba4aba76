"""Query executor (port of `liquid_tpu/sql/exec.py`).

SQL -> parse -> qualify -> plan -> a fused device route or the classic
path -> pa.Table.

Statements: SELECT, `CREATE VIEW` / `DROP VIEW`, CTEs (statement-scoped
views that shadow a stored view and restore it afterwards), UNION /
INTERSECT / EXCEPT [ALL] (INTERSECT binds tighter) and SELECT without
FROM.  A derived table, or a view, that is a plain projection inlines
into the outer query (`_inline_derived`).

Routes, tried in the reference's order:
- one parquet table: the COUNT(*) metadata shortcut, count(DISTINCT)'s
  device routes and host fold, the fused aggregate (`sql/fused_agg.py`),
  with correlated EXISTS / [NOT] IN conjuncts as device existence probes
  (`_plan_exist_probes`); a bare SELECT takes the fused select;
- a join: the fused star path (`sql/fused_star.py`);
- the classic path when those pass (each counts why, `fused_agg.STATS`;
  `STATS` here counts the hand-offs): the scan (`physical.scan_blocks`:
  encoded predicates with K1's single form, a top-k threshold, an early
  LIMIT) or the join source (`_join_source`: per-leaf pushdown, leaves
  under an outer join's NULL side protected, dynamic key bounds, the
  joins folded on the card by `device_join`), into the device
  aggregators (`device_agg`) or the projection.

Subqueries: an uncorrelated one becomes a literal (IN -> an `InList`
that keeps its NULLs, EXISTS -> a bool, a scalar subquery -> its value);
a correlated EXISTS, IN or scalar aggregate becomes a `CorrLookup` over
its inner relation, computed once.  The projection, HAVING and ORDER BY
/ LIMIT run with the host evaluator (`sql/eval.py`).

GROUPING SETS / ROLLUP / CUBE run as one grouped query per set through
the routes above, concatenated (`_exec_grouping_sets`).  Window functions
run on the host (`sql/window.py`) over the result of an inner window-free
query that the routes above answer (`_exec_window`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.eval import Batch, Evaluator
from liquid_tpu_torch.sql.parser import parse_statement
from liquid_tpu_torch.sql.physical import (
    AGG_FUNCS, TopKTracker, collect_columns, find_aggs, make_slots, render,
    scan_blocks, substitute,
)
from liquid_tpu_torch.sql.planner import (
    SUBQUERY_NODES, and_all, column_hints, plan_scan_filters, split_conjuncts,
    subqueries,
)
from liquid_tpu_torch.sql.qualify import Qualifier, map_expr
from liquid_tpu_torch.sql.window import _const, compute_window, find_windows
from liquid_tpu_torch.utils.tracing import TRACER


#: the classic path's hand-offs, by shape: an aggregate, a bare SELECT,
#: a join source materialized (the fused routes' own counters,
#: `fused_agg.STATS`, say why they passed); and the queries run as
#: grouping sets or with windows
STATS = {"classic_aggregates": 0, "classic_selects": 0, "classic_joins": 0,
         "grouping_sets": 0, "windows": 0}


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
        self.views: Dict[str, object] = {}
        #: statement-scoped: id(Select) -> (the Select, its value)
        self._scalar_cache: Dict[int, tuple] = {}

    # -- statements --------------------------------------------------------

    def _base_columns(self, name: str):
        if name in self.views:
            v = self.views[name]
            items = (v.members[0].items if isinstance(v, ast.SetOp)
                     else v.items)
            return [it.alias or render(it.expr) for it in items]
        if name in self.catalog:
            return list(self.catalog[name].column_names)
        return None

    def _qualify(self, q):
        return Qualifier(self._base_columns).qualify(q)

    def execute_sql(self, sql: str) -> pa.Table:
        with TRACER.span("sql.execute", sql=sql[:120]):
            self._scalar_cache.clear()
            stmt = parse_statement(sql)
            if stmt[0] == "create_view":
                self.views[stmt[1]] = stmt[2]
                return pa.table({})
            if stmt[0] == "drop_view":
                self.views.pop(stmt[1], None)
                return pa.table({})
            q = stmt[1]
            if isinstance(q, ast.SetOp):
                return self._execute_setop(q)
            return self._with_ctes(q.ctes, lambda: self.execute(
                self._qualify(q)))

    def _with_ctes(self, ctes, run):
        """Run with the CTEs as views (evaluated on use; a CTE may name an
        earlier one and may shadow a stored view, restored afterwards)."""
        saved = {}
        try:
            for name, sub in ctes:
                saved.setdefault(name, self.views.get(name))
                self.views[name] = sub
            return run()
        finally:
            for name, prior in saved.items():
                if prior is None:
                    self.views.pop(name, None)
                else:
                    self.views[name] = prior

    def _execute_setop(self, u: ast.SetOp, qualified: bool = False
                       ) -> pa.Table:
        """UNION / INTERSECT / EXCEPT [ALL] chain.  INTERSECT binds
        tighter; the rest folds left-associatively.  Columns align by
        position under the first member's names."""
        def run():
            parts = []
            for m in u.members:
                m.ctes = []
                parts.append(self.execute(m if qualified
                                          else self._qualify(m)))
            return parts
        parts = self._with_ctes(u.members[0].ctes, run)
        names = parts[0].column_names
        parts = [p.rename_columns(names) for p in parts]
        ops = list(u.ops) if u.ops else ["union"] * len(u.all_flags)
        alls = list(u.all_flags)
        i = 0
        while i < len(ops):  # INTERSECT first
            if ops[i] == "intersect":
                parts[i:i + 2] = [_setop_apply(parts[i], parts[i + 1],
                                               "intersect", alls[i], names)]
                ops.pop(i)
                alls.pop(i)
            else:
                i += 1
        out = parts[0]
        for part, op, is_all in zip(parts[1:], ops, alls):
            out = _setop_apply(out, part, op, is_all, names)
        if u.order_by:
            keys = []
            for o in u.order_by:
                if isinstance(o.expr, ast.Literal) and isinstance(
                        o.expr.value, int):
                    nm = names[o.expr.value - 1]
                elif isinstance(o.expr, ast.Column):
                    nm = o.expr.name
                else:
                    raise _not_ported("a set operation's ORDER BY over an "
                                      "expression")
                keys.append((nm, o.desc))
            from liquid_tpu_torch.sql.device_sort import try_sort_indices
            # nulls at the end in both directions, as the reference sorts
            idx = try_sort_indices(
                [out.column(nm).combine_chunks() for nm, _ in keys],
                [(desc, False) for _, desc in keys], device=self.device)
            if idx is not None:
                out = out.take(pa.array(idx, pa.int64()))
            else:
                out = out.sort_by([(nm, "descending" if d else "ascending")
                                   for nm, d in keys])
        if u.offset:
            out = out.slice(u.offset)
        if u.limit is not None:
            out = out.slice(0, u.limit)
        return out

    # -- queries -----------------------------------------------------------

    def execute(self, q) -> pa.Table:
        if isinstance(q, ast.SetOp):
            # a nested chain (derived table, CTE or view body), its members
            # qualified by the enclosing pass
            return self._execute_setop(q, qualified=True)
        if q.from_ is None:
            ev = Evaluator(Batch({}, 1), self._scalar_subquery)
            cols = {}
            for it in q.items:
                v = ev.eval(self._rewrite_subqueries(it.expr))
                cols[it.alias or render(it.expr)] = (
                    pa.array([v.as_py()]) if isinstance(v, pa.Scalar) else v)
            return pa.table(cols)
        wfs: List[ast.WindowFunc] = []
        for e in [it.expr for it in q.items] + [o.expr for o in q.order_by]:
            find_windows(e, wfs)
        if wfs:
            return self._exec_window(q, wfs)
        q = self._inline_derived(q)
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

    # -- windows -----------------------------------------------------------
    # Windows evaluate after grouping and HAVING, before DISTINCT and
    # ORDER BY, on the host over the inner query's result.

    def _exec_window(self, q: ast.Select,
                     wfs: List[ast.WindowFunc]) -> pa.Table:
        """A query with window functions: an inner window-free query (the
        same FROM / WHERE / GROUP BY / HAVING, its items every expression
        the windows and the residual projection need) runs through the
        engine's routes; `window.compute_window` adds one column per
        window; the residual items, DISTINCT and ORDER BY / LIMIT run
        over that."""
        STATS["windows"] += 1
        base: Dict[ast.Expr, str] = {}

        def reg(e: ast.Expr) -> str:
            if isinstance(e, ast.Column):
                base.setdefault(e, e.name)
                return e.name
            if e not in base:
                base[e] = f"__b{len(base)}"
            return base[e]

        # constant arguments (ntile(4), lag(x, 2, -1)) are read from the
        # AST by compute_window, not projected
        comp = [([reg(a) for a in wf.func.args if _const(a) is None],
                 [reg(p) for p in wf.partition_by],
                 [reg(o) for o in wf.order_exprs]) for wf in wfs]
        wmap: Dict[ast.Expr, str] = {wf: f"__w{j}"
                                     for j, wf in enumerate(wfs)}
        # group keys register first, so a residual substitutes whole group
        # expressions (it may reference only keys, aggregates and windows)
        alias_map = {it.alias: it.expr for it in q.items if it.alias}
        resolved_group: List[ast.Expr] = []
        for g in q.group_by:
            if isinstance(g, ast.Literal) and isinstance(g.value, int):
                resolved_group.append(q.items[g.value - 1].expr)
            elif isinstance(g, ast.Column) and g.name in alias_map:
                resolved_group.append(alias_map[g.name])
            else:
                resolved_group.append(g)
        gmap = {g: reg(g) for g in resolved_group
                if not isinstance(g, ast.GroupingSpec)}

        def lower(e: ast.Expr, skip_aliases: bool = False) -> ast.Expr:
            def walk(x):
                if isinstance(x, ast.Column):
                    if skip_aliases and x.name in alias_map:
                        return x  # an ORDER BY alias resolves outside
                    if not x.name.startswith("__w"):
                        reg(x)
                    return x
                if isinstance(x, ast.Func) and (x.name in AGG_FUNCS
                                                or x.name == "grouping"):
                    # grouping() folds per set inside the inner
                    # aggregation, like an aggregate's result
                    return ast.Column(reg(x))
                return None
            return map_expr(substitute(substitute(e, wmap), gmap), walk)

        residuals = [lower(it.expr) for it in q.items]
        order_resid = [lower(o.expr, skip_aliases=True) for o in q.order_by]

        inner = ast.Select()
        inner.items = [ast.SelectItem(e, nm) for e, nm in base.items()]
        inner.from_ = q.from_
        inner.where = q.where
        inner.group_by = resolved_group
        inner.having = q.having
        t = self.execute(inner)

        with TRACER.span("sql.windows", n=len(wfs), rows=t.num_rows):
            cols = {n: t.column(n) for n in t.column_names}
            for j, (wf, (argn, partn, ordn)) in enumerate(zip(wfs, comp)):
                cols[f"__w{j}"] = compute_window(t, wf, argn, partn, ordn)
            ns = pa.table(cols)

        batch = Batch.from_table(ns)
        ev = Evaluator(batch, self._scalar_subquery)
        out_cols: Dict[str, pa.Array] = {}
        for it, res in zip(q.items, residuals):
            v = ev.eval(self._rewrite_subqueries(res))
            out_cols[it.alias or render(it.expr)] = (
                pa.repeat(v, batch.length) if isinstance(v, pa.Scalar)
                else v)
        result = pa.table(out_cols)
        internal = None
        mapping: Dict[ast.Expr, str] = {}
        icols = {}
        for i, (o, res) in enumerate(zip(q.order_by, order_resid)):
            if isinstance(o.expr, ast.Literal) or (
                    isinstance(o.expr, ast.Column)
                    and o.expr.name in alias_map):
                continue
            try:
                v = ev.eval(self._rewrite_subqueries(res))
            except KeyError:
                # an expression over item aliases (TPC-DS q36's `case
                # when lochierarchy = 0 ...`) resolves in _order_limit
                # over the projected result
                continue
            icols[f"__ob{i}"] = (pa.repeat(v, batch.length)
                                 if isinstance(v, pa.Scalar) else v)
            mapping[o.expr] = f"__ob{i}"
        if icols:
            internal = pa.table(icols)
        if q.distinct:
            result = result.group_by(result.column_names,
                                     use_threads=False).aggregate([])
            internal = None
        return self._order_limit(q, result, internal, mapping)

    def _inline_derived(self, q: ast.Select) -> ast.Select:
        """A view named alone in FROM reads as its derived table; a derived
        table that is a plain projection inlines (`_inline_derived`)."""
        rel = q.from_
        if isinstance(rel, ast.TableRef) and rel.name in self.views \
                and not rel.prefix:
            q = dataclasses.replace(q, from_=ast.SubqueryRel(
                self._qualify(self.views[rel.name]), rel.alias or rel.name))
        return _inline_derived(q)

    def _is_table(self, rel) -> bool:
        return (isinstance(rel, ast.TableRef) and not rel.prefix
                and rel.name in self.catalog)

    def _single_parquet_source(self, q: ast.Select):
        """The query's one parquet table when FROM names it bare, else None
        (an aliased table goes through the join source's renames)."""
        return self.catalog[q.from_.name] if self._is_table(q.from_) \
            else None

    def _exec_plain(self, q: ast.Select) -> pa.Table:
        """A bare SELECT: the fused select over one parquet table, else the
        classic scan (a top-k threshold pruning later blocks, an early stop
        at LIMIT), or the join source over a join or a derived relation."""
        table = self._single_parquet_source(q)
        star = any(isinstance(it.expr, ast.Star) for it in q.items)
        scope = self._scope_cols(q)
        # ORDER BY expressions that are not select items ride along as
        # internal columns
        item_exprs = {it.expr for it in q.items}
        alias_names = {it.alias for it in q.items if it.alias}
        extras: List[Tuple[str, ast.Expr]] = []
        mapping: Dict[ast.Expr, str] = {}
        for i, o in enumerate(q.order_by):
            e = o.expr
            if (isinstance(e, ast.Literal) and isinstance(e.value, int)) \
                    or (isinstance(e, ast.Column) and e.name in alias_names) \
                    or e in item_exprs:
                continue
            extras.append((f"__ob{i}", e))
            mapping[e] = f"__ob{i}"
        if table is not None:
            rew_where = self._rewrite_subqueries(q.where, scope)
            rq = self._rewrite_query(q, scope, rew_where)
            from liquid_tpu_torch.sql.fused_agg import try_fused_select
            with TRACER.span("sql.fused_select"):
                fsel = try_fused_select(self, table, rq, rew_where)
            if fsel is not None:
                return fsel
            STATS["classic_selects"] += 1
            out, internal = self._scan_plain(rq, table, star, extras)
        else:
            STATS["classic_selects"] += 1
            joined = self._join_source(q)
            batch = Batch.from_table(joined)
            rq = self._rewrite_query(q, scope, q.where)
            out = self._project_rows(rq, batch, None, star)
            internal = (self._project_extras(extras, batch, scope)
                        if extras else None)
        if q.distinct:
            out = out.group_by(out.column_names,
                               use_threads=False).aggregate([])
            internal = None
        return self._order_limit(q, out, internal, mapping)

    def _scan_plain(self, q: ast.Select, table, star: bool, extras):
        """The classic scan of a bare single-table SELECT -> (projected
        rows, internal ORDER BY columns or None)."""
        hints = column_hints(q)
        plan = plan_scan_filters(q.where)
        needed: set = set()
        for it in q.items:
            collect_columns(it.expr, needed)
        for o in q.order_by:
            collect_columns(o.expr, needed)
        if star:
            needed |= set(table.column_names)
        need = sorted(c for c in needed if c in table.column_names)
        parts: List[pa.Table] = []
        iparts: List[pa.Table] = []
        total = 0
        early_limit = (q.limit is not None and not q.order_by
                       and not q.distinct)
        # ORDER BY col LIMIT k publishes a running k-th-best threshold
        # that prunes later blocks and row groups
        track = None
        if q.limit is not None and q.order_by and not q.distinct:
            o0 = q.order_by[0]
            if isinstance(o0.expr, ast.Column) \
                    and o0.expr.name in table.column_names:
                t0 = table.field(o0.expr.name).type
                if (pa.types.is_integer(t0) or pa.types.is_floating(t0)
                        or pa.types.is_date32(t0)):
                    track = TopKTracker(o0.expr.name, bool(o0.desc),
                                        q.limit + (q.offset or 0), t0)
        for block in scan_blocks(table, plan, hints, need,
                                 dynamic=track.current if track else None,
                                 subquery=self._scalar_subquery):
            cols = {c: block.col(c, hints.get(c)) for c in need}
            batch = Batch(cols, block.num_selected)
            parts.append(self._project_rows(q, batch, table, star))
            if extras:
                iparts.append(self._project_extras(extras, batch))
            if track is not None:
                track.update(cols[track.col])
            total += block.num_selected
            if early_limit and total >= q.limit + (q.offset or 0):
                break
        if parts:
            return (pa.concat_tables(parts),
                    pa.concat_tables(iparts) if extras else None)
        empty = Batch({c: pa.array([], table.field(c).type) for c in need}, 0)
        return (self._project_rows(q, empty, table, star),
                self._project_extras(extras, empty) if extras else None)

    def _project_extras(self, extras, batch: Batch,
                        scope: frozenset = frozenset()) -> pa.Table:
        ev = Evaluator(batch, self._scalar_subquery)
        cols = {}
        for nm, e in extras:
            v = ev.eval(self._rewrite_subqueries(e, scope))
            cols[nm] = pa.repeat(v, batch.length) \
                if isinstance(v, pa.Scalar) else v
        return pa.table(cols)

    def _project_rows(self, q: ast.Select, batch: Batch, table,
                      star: bool) -> pa.Table:
        """The select items over a batch of rows (`*` expands to the
        table's columns, or the batch's)."""
        cols: Dict[str, pa.Array] = {}
        ev = Evaluator(batch, self._scalar_subquery)
        for it in q.items:
            if isinstance(it.expr, ast.Star):
                names = (table.column_names if table is not None
                         else list(batch.columns))
                for n in names:
                    cols[n] = ev.eval(ast.Column(n))
                continue
            v = ev.eval(it.expr)
            cols[it.alias or render(it.expr)] = pa.repeat(v, batch.length) \
                if isinstance(v, pa.Scalar) else v
        return pa.table(cols)

    def _rewrite_query(self, q: ast.Select, scope, where) -> ast.Select:
        """q with `where` and its select items and HAVING rewritten
        (subqueries as literals or lookups)."""
        if not any(subqueries(e) for e in [it.expr for it in q.items]
                   + [q.having]) and where is q.where:
            return q
        return dataclasses.replace(
            q, where=where,
            items=[ast.SelectItem(self._rewrite_subqueries(it.expr, scope),
                                  it.alias) for it in q.items],
            having=self._rewrite_subqueries(q.having, scope))

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
        """An aggregate: the fused routes first (metadata count, device
        count(DISTINCT), the fused aggregate, the star join), then the
        classic path: the scan, or the join source, feeding the device
        aggregators in chunks."""
        if any(isinstance(g, ast.GroupingSpec) for g in q.group_by):
            return self._exec_grouping_sets(q)
        table = self._single_parquet_source(q)
        scope = self._scope_cols(q)
        slots = make_slots(aggs)
        group = self._resolve_group_exprs(q)
        key_names = [nm for _, nm in group]
        rew_keys = [self._rewrite_subqueries(ge, scope) for ge, _ in group]
        rew_inputs = {s.name: self._rewrite_subqueries(s.input, scope)
                      for s in slots if s.input is not None}
        final = None
        if table is not None:
            final = self._fused_single(q, table, scope, group, key_names,
                                       slots, rew_keys, rew_inputs)
        else:
            final = self._fused_star(q, scope, group, key_names, slots,
                                     rew_keys, rew_inputs)
        if final is None:
            STATS["classic_aggregates"] += 1
            final = self._classic_aggregate(q, table, scope, group,
                                            key_names, slots, rew_keys,
                                            rew_inputs)
        rq = self._rewrite_query(q, scope, q.where)
        return self._project(rq, group, slots, final)

    def _exec_grouping_sets(self, q: ast.Select) -> pa.Table:
        """GROUP BY ROLLUP / CUBE / GROUPING SETS: one grouped query per
        set, each run by `execute` (so through the fused, star and classic
        routes); a key the set leaves out projects as NULL and
        `grouping(e)` folds to 0 or 1.  HAVING applies per set (the same
        predicate on every part, so equal to applying it to the union);
        ORDER BY / LIMIT apply to the combined result."""
        STATS["grouping_sets"] += 1
        sets_per_elem: List[List[Tuple[ast.Expr, ...]]] = []
        spec_keys: List[ast.Expr] = []
        for g in q.group_by:
            if isinstance(g, ast.GroupingSpec):
                if g.kind == "rollup":
                    ss = [tuple(g.exprs[:i])
                          for i in range(len(g.exprs), -1, -1)]
                elif g.kind == "cube":
                    ss = [tuple(e for e, keep in zip(g.exprs, mask) if keep)
                          for mask in itertools.product(
                              (True, False), repeat=len(g.exprs))]
                else:
                    ss = list(g.sets)
                sets_per_elem.append(ss)
                for e in (g.exprs or tuple(x for s in g.sets for x in s)):
                    if e not in spec_keys:
                        spec_keys.append(e)
            else:
                sets_per_elem.append([(g,)])
        full_keys: List[ast.Expr] = []
        for elem in sets_per_elem:
            for s in elem:
                for e in s:
                    if e not in full_keys:
                        full_keys.append(e)

        def rewrite(e, included: List[ast.Expr], in_agg: bool = False):
            if isinstance(e, ast.Func) and e.name == "grouping":
                return ast.Literal(0 if e.args[0] in included else 1)
            if not in_agg and e in spec_keys and e not in included:
                return ast.Literal(None)
            if not dataclasses.is_dataclass(e):
                return e
            sub_agg = in_agg or (isinstance(e, ast.Func)
                                 and e.name in AGG_FUNCS)

            def rw(x):
                if isinstance(x, ast.Expr):
                    return rewrite(x, included, sub_agg)
                if isinstance(x, tuple):
                    return tuple(rw(y) for y in x)
                return x
            changes = {f.name: rw(getattr(e, f.name))
                       for f in dataclasses.fields(e)
                       if isinstance(getattr(e, f.name), (ast.Expr, tuple))}
            return dataclasses.replace(e, **changes) if changes else e

        names = [it.alias or render(it.expr) for it in q.items]
        parts: List[pa.Table] = []
        for combo in itertools.product(*sets_per_elem):
            included: List[ast.Expr] = []
            for s in combo:
                for e in s:
                    if e not in included:
                        included.append(e)
            qi = ast.Select()
            qi.items = [ast.SelectItem(rewrite(it.expr, included), nm)
                        for it, nm in zip(q.items, names)]
            qi.from_ = q.from_
            qi.where = q.where
            qi.group_by = [k for k in full_keys if k in included]
            qi.having = (rewrite(q.having, included)
                         if q.having is not None else None)
            parts.append(self.execute(qi))
        combined = pa.concat_tables(parts, promote_options="permissive")
        return self._order_limit(q, combined, None, {})

    def _fused_single(self, q, table, scope, group, key_names, slots,
                      rew_keys, rew_inputs) -> Optional[pa.Table]:
        """The fused routes over one parquet table, or None.  Existence
        probes take what correlated conjuncts they can; the rest of the
        WHERE is rewritten (its subqueries as literals or lookups)."""
        where, especs = self._plan_exist_probes(q.where, table)
        where = self._rewrite_subqueries(where, scope)
        plan = plan_scan_filters(where)
        needed: set = set()
        for ge in rew_keys:
            collect_columns(ge, needed)
        for e in rew_inputs.values():
            collect_columns(e, needed)
        if (not needed and not group and not especs
                and all(s.kind == "count_star" for s in slots)
                and not plan.pushdown and not plan.residual):
            # COUNT(*) without a filter: parquet metadata only
            return pa.table({s.name: pa.array([table.num_rows], pa.int64())
                             for s in slots})
        from liquid_tpu_torch.sql import fused_agg
        hints = column_hints(q)
        rq = self._rewrite_query(q, scope, where)
        if any(s.kind == "count_distinct" for s in slots) and not especs:
            with TRACER.span("sql.fused_distinct"):
                final = fused_agg.distinct_fused_device(
                    table, plan, hints, group, key_names, slots, rew_keys,
                    rew_inputs, rq)
                if final is None:
                    final = fused_agg.distinct_two_level(
                        slots, group, key_names, rew_keys, rew_inputs,
                        lambda g2, kn2, s2, rk2, ri2:
                        fused_agg.try_fused_aggregate(
                            table, plan, hints, g2, kn2, s2, rk2, ri2))
                if final is not None:
                    return final
        with TRACER.span("sql.fused_aggregate"):
            return fused_agg.try_fused_aggregate(
                table, plan, hints, group, key_names, slots, rew_keys,
                rew_inputs, rq, especs)

    def _fused_star(self, q, scope, group, key_names, slots, rew_keys,
                    rew_inputs) -> Optional[pa.Table]:
        """The fused star route over a join, or None.  A correlated
        conjunct stays whole: the star planner takes it as an existence
        probe on the fact, or passes."""
        if not isinstance(q.from_, ast.Join):
            return None
        from liquid_tpu_torch.sql.fused_agg import distinct_two_level
        from liquid_tpu_torch.sql.fused_star import try_fused_star
        where = and_all([c if self._correlated(c, scope)
                         else self._rewrite_subqueries(c, scope)
                         for c in split_conjuncts(q.where)])
        rq = self._rewrite_query(q, scope, where)
        # the fold's inner aggregate is not the query: its ORDER BY, LIMIT
        # and HAVING must not cut the inner rows
        inner_q = dataclasses.replace(rq, order_by=[], limit=None,
                                      offset=None, having=None)
        with TRACER.span("sql.fused_star"):
            final = distinct_two_level(
                slots, group, key_names, rew_keys, rew_inputs,
                lambda g2, kn2, s2, rk2, ri2: try_fused_star(
                    self, inner_q, g2, kn2, s2, rk2, ri2, where))
            if final is None:
                final = try_fused_star(self, rq, group, key_names, slots,
                                       rew_keys, rew_inputs, where)
        return final

    def _classic_aggregate(self, q, table, scope, group, key_names, slots,
                           rew_keys, rew_inputs) -> pa.Table:
        """The classic aggregate: selected rows in ~256k-row chunks (or the
        joined table) into the hybrid aggregators."""
        from liquid_tpu_torch.sql.device_agg import (
            HybridGroupedAggregator, HybridScalarAggregator)
        agg = (HybridGroupedAggregator(key_names, slots, self.device)
               if group else HybridScalarAggregator(slots, self.device))
        input_types: Dict[str, pa.DataType] = {}

        def update_from(batch: Batch):
            ev = Evaluator(batch, self._scalar_subquery)
            inputs: Dict[str, pa.Array] = {}
            for s in slots:
                if s.input is not None:
                    arr = ev.arr(rew_inputs[s.name])
                    inputs[s.name] = arr
                    input_types.setdefault(s.name, arr.type)
            if group:
                agg.update([ev.arr(ge) for ge in rew_keys], inputs,
                           batch.length)
            else:
                agg.update(inputs, batch.length)

        if table is not None:
            hints = column_hints(q)
            plan = plan_scan_filters(self._rewrite_subqueries(q.where, scope))
            needed: set = set()
            for ge in rew_keys:
                collect_columns(ge, needed)
            for e in rew_inputs.values():
                collect_columns(e, needed)
            need = sorted(c for c in needed if c in table.column_names)
            buf: List[pa.Table] = []
            buf_rows = plain_rows = 0

            def flush():
                nonlocal buf, buf_rows
                if buf:
                    update_from(Batch.from_table(pa.concat_tables(buf)))
                    buf, buf_rows = [], 0

            for block in scan_blocks(table, plan, hints, need,
                                     subquery=self._scalar_subquery):
                if not need:
                    if group:  # constant keys: a batch of the right length
                        update_from(Batch({}, block.num_selected))
                    else:
                        plain_rows += block.num_selected
                    continue
                buf.append(pa.table({c: block.col(c, hints.get(c))
                                     for c in need}))
                buf_rows += block.num_selected
                if buf_rows >= (1 << 18):
                    flush()
            flush()
            if plain_rows:
                agg.update({}, plain_rows)
        else:
            joined = self._join_source(q)
            if joined.num_rows:
                update_from(Batch.from_table(joined))
            elif not group:
                agg.update({s.name: pa.array(
                    [], input_types.get(s.name) or pa.int64())
                    for s in slots if s.input is not None}, 0)
        final = agg.finalize() if group else agg.finalize(input_types)
        if final.num_rows == 0 and table is not None:
            # no update typed the columns: the schema does
            final = _retype_empty(final, group, slots, rew_inputs, table)
        return final

    # -- the join source -----------------------------------------------------

    def _leaf_relations(self, rel, out: List) -> None:
        if isinstance(rel, ast.Join):
            self._leaf_relations(rel.left, out)
            self._leaf_relations(rel.right, out)
        else:
            out.append(rel)

    def _relation_columns(self, rel) -> List[str]:
        if isinstance(rel, ast.TableRef):
            cols = self._base_columns(rel.name)
            if cols is None:
                raise KeyError(f"unknown relation {rel.name}")
        elif isinstance(rel, ast.SubqueryRel):
            cols = Qualifier(self._base_columns)._output_columns(rel.query)
        else:
            raise _not_ported(f"relation {type(rel).__name__}")
        return [rel.prefix + c for c in cols] if rel.prefix else cols

    def _scope_cols(self, q: ast.Select) -> frozenset:
        leaves: List = []
        self._leaf_relations(q.from_, leaves)
        out: set = set()
        for leaf in leaves:
            if leaf is not None:
                out.update(self._relation_columns(leaf))
        return frozenset(out)

    def _scan_relation_batches(self, table, where, needed: List[str]):
        """Filtered Batches of a parquet table (the pushdown scan)."""
        plan = plan_scan_filters(where)
        for block in scan_blocks(table, plan, {}, needed,
                                 subquery=self._scalar_subquery):
            yield Batch({c: block.col(c) for c in needed},
                        block.num_selected)

    def _materialize_relation(self, rel, where, needed: List[str]
                              ) -> pa.Table:
        """One leaf of FROM as an arrow table: a parquet table scanned with
        its pushed filters (an alias prefix stripped for the scan and put
        back after), or a view or derived table executed and filtered."""
        if isinstance(rel, ast.TableRef) and rel.name in self.catalog \
                and rel.name not in self.views:
            table = self.catalog[rel.name]
            pfx = rel.prefix or ""
            if pfx:
                strip = {pfx + c: c for c in table.column_names}
                if where is not None:
                    where = map_expr(where, lambda e: ast.Column(
                        strip[e.name]) if isinstance(e, ast.Column)
                        and e.name in strip else None)
                needed = [strip.get(c, c) for c in needed]
            needed = [c for c in needed if c in table.column_names] or \
                list(table.column_names[:1])
            parts = [b.to_table() for b in
                     self._scan_relation_batches(table, where, needed)]
            out = pa.concat_tables(parts) if parts else pa.table(
                {c: pa.array([], table.field(c).type) for c in needed})
            if pfx:
                out = out.rename_columns([pfx + c for c in out.column_names])
            return out
        if isinstance(rel, ast.TableRef) and rel.name in self.views:
            t = self.execute(self._qualify(self.views[rel.name]))
        elif isinstance(rel, ast.SubqueryRel):
            t = self.execute(rel.query)
        else:
            raise KeyError(f"unknown relation {rel}")
        if rel.prefix:
            t = t.rename_columns([rel.prefix + c for c in t.column_names])
        return self._filter_table(t, where)

    def _filter_table(self, t: pa.Table, where) -> pa.Table:
        if where is None or t.num_rows == 0:
            return t
        m = Evaluator(Batch.from_table(t), self._scalar_subquery).arr(where)
        return t.filter(pc.fill_null(m.cast(pa.bool_()), False))

    def _join_source(self, q: ast.Select) -> pa.Table:
        """The FROM tree as one joined table: each leaf materialized with
        its own WHERE conjuncts pushed down (not a leaf under the NULL
        side of an outer join: WHERE applies after the NULL extension),
        the outer joins' single-leaf ON filters applied before the join,
        an inner equi-join's materialized key range pushed onto the
        pending side's scan, the joins folded, and the rest of WHERE
        applied to the result."""
        STATS["classic_joins"] += 1
        conjuncts = split_conjuncts(self._rewrite_subqueries(
            q.where, self._scope_cols(q)))
        needed_all: set = set()
        for e in [it.expr for it in q.items] + conjuncts + list(q.group_by) \
                + [q.having] + [o.expr for o in q.order_by]:
            collect_columns(e, needed_all)
        self._collect_join_columns(q.from_, needed_all)
        leaves: List = []
        self._leaf_relations(q.from_, leaves)
        leaf_cols = {id(x): set(self._relation_columns(x)) for x in leaves}

        def owner(cols: set):
            owners = [x for x in leaves if cols <= leaf_cols[id(x)]]
            return owners[0] if len(owners) == 1 else None

        protected: set = set()
        self._collect_protected(q.from_, protected)
        pushed: Dict[int, List[ast.Expr]] = {id(x): [] for x in leaves}
        residual: List[ast.Expr] = []
        for e in conjuncts:
            cols: set = set()
            collect_columns(e, cols)
            o = owner(cols)
            if o is not None and id(o) not in protected \
                    and not subqueries(e):
                pushed[id(o)].append(e)
            else:
                residual.append(e)
        from_ = self._push_on_filters(q.from_, pushed, owner)
        # dynamic join-key bounds: after one side of an INNER equi-join
        # edge is materialized, its key min / max become range conjuncts
        # on the pending side's scan (rows outside can never match)
        edges: List[Tuple[str, str]] = [
            (e.left.name, e.right.name) for e in conjuncts if _col_eq(e)]
        self._collect_inner_on_edges(q.from_, edges)
        bounds: Dict[int, List[ast.Expr]] = {id(x): [] for x in leaves}
        done: set = set()
        tables: Dict[int, pa.Table] = {}
        for leaf in leaves:
            need = sorted(needed_all & leaf_cols[id(leaf)])
            t = self._materialize_relation(
                leaf, and_all(pushed[id(leaf)] + bounds[id(leaf)]), need)
            tables[id(leaf)] = t
            done.add(id(leaf))
            if id(leaf) in protected:
                continue
            for c1, c2 in edges:
                for a, b in ((c1, c2), (c2, c1)):
                    la, lb = owner({a}), owner({b})
                    if la is not leaf or lb is None or id(lb) in done \
                            or id(lb) in protected:
                        continue
                    bounds[id(lb)] += _key_bounds(t, a, b)
        joined = self._fold_join(from_, tables, residual)
        return self._filter_table(joined, and_all(residual))

    def _collect_inner_on_edges(self, rel, out: List) -> None:
        """Equality edges of INNER join ON conditions (an outer join's
        NULL-extended rows must survive)."""
        if not isinstance(rel, ast.Join):
            return
        self._collect_inner_on_edges(rel.left, out)
        self._collect_inner_on_edges(rel.right, out)
        if rel.kind == "inner" and rel.on is not None:
            out += [(c.left.name, c.right.name)
                    for c in split_conjuncts(rel.on) if _col_eq(c)]

    def _collect_protected(self, rel, out: set, under_outer=False) -> None:
        """The leaves on the NULL-producing side of an outer join."""
        if isinstance(rel, ast.Join):
            self._collect_protected(rel.left, out, under_outer
                                    or rel.kind in ("right", "full"))
            self._collect_protected(rel.right, out, under_outer
                                    or rel.kind in ("left", "full"))
        elif rel is not None and under_outer:
            out.add(id(rel))

    def _push_on_filters(self, rel, pushed, owner):
        """Single-leaf non-equi ON conjuncts move into their leaf's
        pre-join filter (they apply before the NULL extension, unlike
        WHERE: TPC-H q13's `o_comment not like ...`)."""
        if not isinstance(rel, ast.Join):
            return rel
        left = self._push_on_filters(rel.left, pushed, owner)
        right = self._push_on_filters(rel.right, pushed, owner)
        if rel.on is None:
            return ast.Join(left, right, rel.kind, None)
        keep: List[ast.Expr] = []
        for c in split_conjuncts(rel.on):
            cols: set = set()
            collect_columns(c, cols)
            o = owner(cols)
            if o is not None and not _col_eq(c) and not subqueries(c):
                pushed[id(o)].append(c)
            else:
                keep.append(c)
        return ast.Join(left, right, rel.kind, and_all(keep))

    def _collect_cross(self, rel, tables, residual, comps: List) -> None:
        """A maximal cross-join subtree flattened into component tables."""
        if isinstance(rel, ast.Join) and rel.kind == "cross" \
                and rel.on is None:
            self._collect_cross(rel.left, tables, residual, comps)
            self._collect_cross(rel.right, tables, residual, comps)
        else:
            comps.append(self._fold_join(rel, tables, residual))

    def _join_components(self, comps: List[pa.Table],
                         residual: List[ast.Expr]) -> pa.Table:
        """Greedy equi-join order over cross-join components: from the
        first, join the component with the most WHERE equalities to the
        current result (consumed as keys); an unconnected one is a true
        cross product."""
        remaining = list(comps)
        cur = remaining.pop(0)
        while remaining:
            best = None  # (index, [(lkey, rkey)], [conjunct])
            for i, comp in enumerate(remaining):
                pairs, used = [], []
                for e in residual:
                    pair = _equi_pair(e, cur.column_names, comp.column_names)
                    if pair is not None:
                        pairs.append(pair)
                        used.append(e)
                if pairs and (best is None or len(pairs) > len(best[1])):
                    best = (i, pairs, used)
            if best is None:
                comp = remaining.pop(min(range(len(remaining)),
                                         key=lambda i: remaining[i].num_rows))
                zl = pa.array(np.zeros(cur.num_rows, np.int8))
                zr = pa.array(np.zeros(comp.num_rows, np.int8))
                cur = cur.append_column("__x", zl).join(
                    comp.append_column("__x", zr), keys=["__x"],
                    join_type="inner").drop_columns(["__x"])
                continue
            i, pairs, used = best
            comp = remaining.pop(i)
            for e in used:
                residual.remove(e)
            cur = self._equi_join(cur, comp, pairs, "inner")
        return cur

    def _equi_join(self, left: pa.Table, right: pa.Table, pairs,
                   kind: str) -> pa.Table:
        """One equi-join on (left key, right key) pairs: the device
        sort-merge, else pyarrow's hash join with both sides' key columns
        kept under their own names."""
        from liquid_tpu_torch.sql.device_join import try_device_join
        lkeys = [p[0] for p in pairs]
        rkeys = [p[1] for p in pairs]
        left = _fix_null_keys(left, lkeys, right, rkeys)
        right = _fix_null_keys(right, rkeys, left, lkeys)
        out = try_device_join(left, right, lkeys, rkeys, kind, self.device)
        if out is not None:
            return out
        jt = {"inner": "inner", "left": "left outer",
              "right": "right outer", "full": "full outer"}[kind]
        if kind != "inner":
            # pyarrow coalesces outer keys: carry each side's own
            for lk, rk in pairs:
                left = left.append_column("__l__" + lk, left.column(lk))
                right = right.append_column("__r__" + rk, right.column(rk))
        out = left.join(right, keys=lkeys, right_keys=rkeys, join_type=jt)
        if kind != "inner":
            cols = {n: out.column(n) for n in out.column_names}
            for lk, rk in pairs:
                cols[lk] = cols.pop("__l__" + lk)
                cols[rk] = cols.pop("__r__" + rk)
            return pa.table(cols)
        # pyarrow drops the right keys: put them back under their names
        for lk, rk in pairs:
            if rk not in out.column_names and lk in out.column_names:
                out = out.append_column(rk, out.column(lk))
        return out

    def _collect_join_columns(self, rel, out: set) -> None:
        if isinstance(rel, ast.Join):
            if rel.on is not None:
                collect_columns(rel.on, out)
            self._collect_join_columns(rel.left, out)
            self._collect_join_columns(rel.right, out)

    def _fold_join(self, rel, tables: Dict[int, pa.Table],
                   residual: List[ast.Expr]) -> pa.Table:
        if not isinstance(rel, ast.Join):
            return tables[id(rel)]
        if rel.kind == "cross" and rel.on is None:
            # a comma-join subtree: components joined greedily on the
            # WHERE equalities (no astronomical cross products)
            comps: List[pa.Table] = []
            self._collect_cross(rel, tables, residual, comps)
            return self._join_components(comps, residual)
        left = self._fold_join(rel.left, tables, residual)
        right = self._fold_join(rel.right, tables, residual)
        pairs, extra = [], []
        for c in split_conjuncts(rel.on):
            pair = _equi_pair(c, left.column_names, right.column_names)
            (pairs if pair else extra).append(pair or c)
        if not pairs:
            raise _not_ported("a non-equi join without keys")
        out = self._equi_join(left, right, pairs, rel.kind)
        if extra:
            if rel.kind == "inner":
                residual.extend(extra)
            else:
                # an outer join's ON residual, applied after the join
                out = self._filter_table(out, and_all(extra))
        return out

    # -- subqueries --------------------------------------------------------

    def _split_correlation(self, sub: ast.Select, inner_cols: frozenset,
                           scope: frozenset) -> dict:
        """The subquery's WHERE conjuncts by kind: eq [(inner column,
        outer expression)] equality correlations, extra (other conjuncts
        that reference the outer query), local (inner columns only)."""
        def refs(x):
            c: set = set()
            collect_columns(x, c)
            return c
        eq, extra, local = [], [], []
        for conj in split_conjuncts(sub.where):
            if not (refs(conj) - inner_cols):
                local.append(conj)
                continue
            pair = None
            if isinstance(conj, ast.Binary) and conj.op == "=":
                for a, b in ((conj.left, conj.right),
                             (conj.right, conj.left)):
                    if (isinstance(a, ast.Column) and a.name in inner_cols
                            and refs(b) and refs(b) <= (scope - inner_cols)
                            and not subqueries(b)):
                        pair = (a.name, b)
                        break
            if pair is not None:
                eq.append(pair)
            else:
                extra.append(conj)
        return {"eq": eq, "extra": extra, "local": local}

    def _corr_of(self, sub, scope: frozenset) -> Optional[dict]:
        """The correlation split of a subquery, or None when it is not
        correlated."""
        if not isinstance(sub, ast.Select) or sub.from_ is None:
            return None
        corr = self._split_correlation(sub, self._scope_cols(sub), scope)
        return corr if corr["eq"] or corr["extra"] else None

    def _correlated(self, e, scope: frozenset) -> bool:
        """Does a subquery of `e` reference the outer query?"""
        return any(self._corr_of(s.query, scope) is not None
                   for s in subqueries(e))

    def _rewrite_subqueries(self, e, scope: frozenset = frozenset()):
        """Subqueries rewritten: an uncorrelated IN -> an InList (its NULLs
        kept: the evaluator applies three-valued IN / NOT IN), EXISTS -> a
        bool, a scalar subquery -> its value; a correlated EXISTS, IN or
        scalar aggregate -> a CorrLookup over its precomputed inner table."""
        if e is None:
            return None

        def walk(x):
            if not isinstance(x, SUBQUERY_NODES):
                return None
            sub = x.query
            corr = self._corr_of(sub, scope)
            if isinstance(x, ast.InSubquery):
                if corr is not None:
                    # EXISTS with one more equality, on the operand
                    op_col = sub.items[0].alias or render(sub.items[0].expr)
                    return self._build_exists(
                        sub, corr, [p[1] for p in corr["eq"]]
                        + [self._rewrite_subqueries(x.operand, scope)],
                        [p[0] for p in corr["eq"]] + [op_col], x.negated,
                        extra_item=sub.items[0])
                t = self.execute(sub)
                vals = tuple(ast.Literal(v) for v in
                             dict.fromkeys(t.column(0).to_pylist()))
                return ast.InList(self._rewrite_subqueries(x.operand, scope),
                                  vals, x.negated)
            if isinstance(x, ast.Exists):
                if corr is None:
                    return ast.Literal(self._exists(sub) != x.negated)
                if not corr["eq"]:
                    # the reference fails on this shape too
                    raise _not_ported("a correlated EXISTS with no "
                                      "equality correlation")
                return self._build_exists(sub, corr,
                                          [p[1] for p in corr["eq"]],
                                          [p[0] for p in corr["eq"]],
                                          x.negated)
            if corr is None:
                return ast.Literal(self._scalar_subquery(sub).as_py())
            if corr["extra"]:
                raise _not_ported("a correlated scalar subquery with a "
                                  "non-equality correlation")
            return self._build_scalar_lookup(sub, corr)
        return map_expr(e, walk)

    def _build_exists(self, sub: ast.Select, corr, keys, inner_keys,
                      negated: bool, extra_item=None) -> ast.CorrLookup:
        """The inner relation of a correlated EXISTS / IN, computed once:
        its key columns (and the columns of the `extra` residual), as a
        CorrLookup of kind "exists"."""
        outer_refs: List[ast.Expr] = []
        inner_cols = self._scope_cols(sub)

        def repl_outer(x):
            if isinstance(x, ast.Column) and x.name not in inner_cols:
                if x not in outer_refs:
                    outer_refs.append(x)
                return ast.Column(f"__outer{outer_refs.index(x)}")
            return None

        extra = None
        extra_cols: set = set()
        if corr["extra"]:
            extra = and_all([map_expr(c, repl_outer) for c in corr["extra"]])
            collect_columns(extra, extra_cols)
            extra_cols = {c for c in extra_cols
                          if not c.startswith("__outer")}
        item_name = (extra_item.alias or render(extra_item.expr)
                     if extra_item is not None else None)
        items = [ast.SelectItem(ast.Column(k), k) for k in inner_keys
                 if k != item_name]
        if extra_item is not None:
            items.append(ast.SelectItem(extra_item.expr, item_name))
        items += [ast.SelectItem(ast.Column(c), c)
                  for c in sorted(extra_cols - set(inner_keys))]
        inner_q = ast.Select()
        inner_q.items = items
        inner_q.from_ = sub.from_
        inner_q.where = and_all(corr["local"])
        inner_q.distinct = extra is None
        return ast.CorrLookup(keys=tuple(keys), key_cols=tuple(inner_keys),
                              kind="exists", table=self.execute(inner_q),
                              negated=negated, outer_refs=tuple(outer_refs),
                              extra=extra)

    def _build_scalar_lookup(self, sub: ast.Select, corr) -> ast.CorrLookup:
        """The inner relation of a correlated scalar aggregate, computed
        once and grouped by its correlation keys (`__v` the value)."""
        if len(sub.items) != 1:
            raise ValueError("a scalar subquery has one select item")
        inner_keys = [p[0] for p in corr["eq"]]
        inner_q = ast.Select()
        inner_q.items = [ast.SelectItem(ast.Column(k), k)
                         for k in inner_keys]
        inner_q.items.append(ast.SelectItem(sub.items[0].expr, "__v"))
        inner_q.from_ = sub.from_
        inner_q.where = and_all(corr["local"])
        inner_q.group_by = [ast.Column(k) for k in inner_keys]
        return ast.CorrLookup(keys=tuple(p[1] for p in corr["eq"]),
                              key_cols=tuple(inner_keys), kind="scalar",
                              table=self.execute(inner_q))

    def _exists(self, sub) -> bool:
        """Does an uncorrelated subquery return a row?  A plain filter
        counts its rows (its select items do not matter)."""
        aggs: List[ast.Func] = []
        for it in getattr(sub, "items", ()):
            if not isinstance(it.expr, ast.Star):
                find_aggs(it.expr, aggs)
        if isinstance(sub, ast.Select) and not (
                aggs or sub.group_by or sub.having is not None
                or sub.limit is not None or sub.offset):
            count = dataclasses.replace(
                sub, items=[ast.SelectItem(ast.Func("count", (), star=True),
                                           "n")],
                order_by=[], distinct=False)
            return self.execute(count).column(0)[0].as_py() > 0
        return self.execute(sub).num_rows > 0

    def _scalar_subquery(self, sub: ast.Select):
        # keyed by identity with the Select pinned in the value: a bare
        # id() can be reused by a new object once the old one is freed
        cached = self._scalar_cache.get(id(sub))
        if cached is not None and cached[0] is sub:
            return cached[1]
        t = self.execute(sub)
        if t.num_columns != 1 or t.num_rows > 1:
            raise ValueError(f"a scalar subquery returned {t.num_rows} rows "
                             f"of {t.num_columns} columns")
        out = pa.scalar(None) if t.num_rows == 0 else t.column(0)[0]
        self._scalar_cache[id(sub)] = (sub, out)
        return out

    # -- existence probes --------------------------------------------------

    def _plan_exist_probes(self, where, fact_table):
        """Split `where` into (the rest, probe specs): each spec runs one
        EXISTS / NOT EXISTS / [NOT] IN <subquery> conjunct as a device
        existence probe (`fused_star.build_exist_probe`).  A conjunct
        whose shape or build does not fit stays in the rest."""
        from liquid_tpu_torch.sql.fused_star import build_exist_probe
        if where is None:
            return None, ()
        specs, rest = [], []
        for e in split_conjuncts(where):
            s = self._exist_spec(e, fact_table)
            probe = None if s is None else build_exist_probe(
                s["table"], s["key"], s["local"], s["mm_inner"],
                require_nonnull_key=s["mode"] == "anti_nn")
            if probe is None:
                rest.append(e)
                continue
            specs.append({"mode": s["mode"], "col": s["col"],
                          "mmcol": s["mmcol"], "probe": probe,
                          "key": repr(e)})
        if not specs:
            return where, ()
        return and_all(rest), tuple(specs)

    def _exist_spec(self, e, fact_table) -> Optional[dict]:
        """The probe shape of one conjunct: {table, key (inner key column),
        local (inner-only WHERE), mm_inner, mode ("semi" | "anti" |
        "anti_nn"), col (the fact's key column), mmcol} or None.  mm is
        the `inner.c <> outer.c` disambiguator of TPC-H q21."""
        fact_cols = set(fact_table.column_names)

        def split_inner(sub, negated, operand=None):
            if not isinstance(sub, ast.Select) or sub.ctes \
                    or sub.group_by or sub.having is not None \
                    or sub.distinct or sub.limit is not None:
                return None
            if not isinstance(sub.from_, ast.TableRef) \
                    or sub.from_.name not in self.catalog:
                return None
            inner_t = self.catalog[sub.from_.name]
            pfx = sub.from_.prefix

            def unpfx(x):
                # an aliased inner relation (lineitem l2) only names its
                # columns: strip its prefix; outer references keep theirs
                if x is None or not pfx:
                    return x
                return map_expr(x, lambda y: ast.Column(y.name[len(pfx):])
                                if isinstance(y, ast.Column)
                                and y.name.startswith(pfx) else None)
            inner_cols = set(inner_t.column_names)
            key_col = fcol = None
            if operand is not None:  # IN <subquery>
                if not (isinstance(operand, ast.Column)
                        and operand.name in fact_cols
                        and operand.name not in inner_cols):
                    return None
                item = unpfx(sub.items[0].expr) if len(sub.items) == 1 \
                    else None
                if not (isinstance(item, ast.Column)
                        and item.name in inner_cols):
                    return None
                key_col, fcol = item.name, operand.name
            local, mm = [], None
            for c in split_conjuncts(unpfx(sub.where)):
                if subqueries(c):
                    return None
                cols: set = set()
                collect_columns(c, cols)
                if cols <= inner_cols:
                    local.append(c)
                    continue
                if not (isinstance(c, ast.Binary)
                        and isinstance(c.left, ast.Column)
                        and isinstance(c.right, ast.Column)):
                    return None
                lname, rname = c.left.name, c.right.name
                if lname in fact_cols and rname in inner_cols:
                    fc, ic = lname, rname
                elif rname in fact_cols and lname in inner_cols:
                    fc, ic = rname, lname
                else:
                    return None
                if fc in inner_cols or ic in fact_cols:
                    return None  # ambiguous ownership
                if c.op == "=" and key_col is None:
                    key_col, fcol = ic, fc
                elif c.op in ("<>", "!=") and mm is None:
                    mm = (ic, fc)
                else:
                    return None
            if key_col is None:
                return None
            mode = ("anti_nn" if (operand is not None and negated)
                    else "anti" if negated else "semi")
            return {"table": inner_t, "key": key_col,
                    "local": and_all(local),
                    "mm_inner": mm[0] if mm else None, "mode": mode,
                    "col": fcol, "mmcol": mm[1] if mm else None}

        if isinstance(e, ast.Exists):
            return split_inner(e.query, e.negated)
        if isinstance(e, ast.Unary) and e.op == "not" \
                and isinstance(e.operand, ast.Exists):
            return split_inner(e.operand.query, not e.operand.negated)
        if isinstance(e, ast.InSubquery):
            return split_inner(e.query, e.negated, operand=e.operand)
        return None

    # -- projection --------------------------------------------------------

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


def _inline_derived(q: ast.Select) -> ast.Select:
    """Inline a derived table that is a plain projection: ``SELECT ...
    FROM (SELECT <exprs> FROM <rels> WHERE <w>) AS s ...`` becomes the
    flat query over <rels>, the derived names replaced by their defining
    expressions and the WHERE clauses AND-ed.  TPC-H q7, q8, q9 and q22
    wrap their joins this way.  Only the provably safe shape inlines: no
    aggregates, grouping, windows, DISTINCT, ORDER BY, LIMIT / OFFSET,
    HAVING, set operations or CTEs inside, and no prefix on the derived
    relation."""
    rel = q.from_
    if not isinstance(rel, ast.SubqueryRel) or rel.prefix:
        return q
    inner = rel.query
    if not isinstance(inner, ast.Select) or inner.from_ is None:
        return q
    if (inner.group_by or inner.having is not None or inner.distinct
            or inner.limit is not None or inner.offset is not None
            or inner.ctes or inner.order_by):
        return q
    inner_aggs: List[ast.Func] = []
    for it in inner.items:
        if it.expr is None or isinstance(it.expr, ast.Star) \
                or _contains(it.expr, ast.WindowFunc):
            return q
        find_aggs(it.expr, inner_aggs)
    if inner_aggs:
        return q
    mapping = {(it.alias or render(it.expr)): it.expr for it in inner.items}

    def subst(e):
        if e is None:
            return None
        return map_expr(e, lambda x: mapping.get(x.name)
                        if isinstance(x, ast.Column) else None)

    q2 = ast.Select()
    q2.items = []
    for it in q.items:
        if isinstance(it.expr, ast.Star):  # the derived table's columns
            q2.items += [ast.SelectItem(e, nm) for nm, e in mapping.items()]
        else:
            q2.items.append(ast.SelectItem(subst(it.expr),
                                           it.alias or render(it.expr)))
    q2.from_ = inner.from_
    q2.where = and_all([w for w in (inner.where, subst(q.where))
                         if w is not None])
    q2.group_by = [subst(g) for g in q.group_by]
    q2.having = subst(q.having)
    q2.order_by = [ast.OrderItem(subst(o.expr), o.desc, o.nulls_first)
                   for o in q.order_by]
    q2.limit, q2.offset, q2.distinct = q.limit, q.offset, q.distinct
    q2.ctes = q.ctes
    return _inline_derived(q2)


def _retype_empty(final: pa.Table, group, slots, rew_inputs,
                  table) -> pa.Table:
    """An EMPTY aggregate result's null-typed columns cast to the types
    the schema gives them (plain-column keys and aggregate inputs)."""
    from liquid_tpu_torch.sql.physical import _sum_type
    cols = {}
    slot_by_name = {s.name: s for s in slots}
    for i, name in enumerate(final.column_names):
        col = final.column(i)
        if not pa.types.is_null(col.type):
            cols[name] = col
            continue
        t = None
        for ge, nm in group:
            if nm == name and isinstance(ge, ast.Column) \
                    and ge.name in table.column_names:
                t = table.field(ge.name).type
        s = slot_by_name.get(name)
        if s is not None:
            e = rew_inputs.get(s.name)
            it = (table.field(e.name).type if isinstance(e, ast.Column)
                  and e.name in table.column_names else None)
            if s.kind in ("count_star", "count", "count_distinct"):
                t = pa.int64()
            elif s.kind in ("avg", "stddev", "var"):
                t = pa.float64()
            elif s.kind in ("min", "max", "median") and it is not None:
                t = it
            elif s.kind == "sum" and it is not None:
                t = _sum_type(it)
        if t is not None and pa.types.is_dictionary(t):
            t = t.value_type
        cols[name] = pa.array([], t) if t is not None else col
    return pa.table(cols)


def _fix_null_keys(t: pa.Table, keys: List[str], other: pa.Table,
                   other_keys: List[str]) -> pa.Table:
    """An empty relation can carry null-typed key columns (no rows to
    type them); a join rejects null keys, so they take the other side's
    type.  By index: a self-join of derived tables repeats names."""
    for k, ok in zip(keys, other_keys):
        for idx, n in enumerate(t.column_names):
            if n != k or not pa.types.is_null(t.column(idx).type):
                continue
            oidx = (other.column_names.index(ok)
                    if ok in other.column_names else -1)
            target = other.column(oidx).type if oidx >= 0 else pa.int64()
            if pa.types.is_null(target):
                target = pa.int64()
            t = t.set_column(idx, k, t.column(idx).cast(target))
    return t


def _key_bounds(t: pa.Table, src_col: str, dst_col: str) -> List[ast.Expr]:
    """`dst_col between min(src) and max(src)` over a materialized join
    side; an EMPTY side gives an impossible range (the inner join yields
    nothing, and the pending scan prunes away)."""
    if src_col not in t.column_names:
        return []
    col = t.column(src_col)
    typ = col.type
    if not (pa.types.is_integer(typ) or pa.types.is_floating(typ)
            or pa.types.is_date32(typ)):
        return []
    if t.num_rows == 0:
        return [ast.Binary(">=", ast.Column(dst_col), ast.Literal(1)),
                ast.Binary("<=", ast.Column(dst_col), ast.Literal(0))]
    mm = pc.min_max(col)
    lo, hi = mm["min"].as_py(), mm["max"].as_py()
    if lo is None or hi is None:
        return []
    return [ast.Binary(">=", ast.Column(dst_col), ast.Literal(lo)),
            ast.Binary("<=", ast.Column(dst_col), ast.Literal(hi))]


def _col_eq(e) -> bool:
    """Is `e` an equality of two columns?"""
    return (isinstance(e, ast.Binary) and e.op == "="
            and isinstance(e.left, ast.Column)
            and isinstance(e.right, ast.Column))


def _equi_pair(e, left_cols, right_cols):
    """(left column, right column) of an equality between the two sides,
    or None."""
    if _col_eq(e):
        a, b = e.left.name, e.right.name
        if a in left_cols and b in right_cols:
            return (a, b)
        if b in left_cols and a in right_cols:
            return (b, a)
    return None


def _setop_apply(left: pa.Table, right: pa.Table, op: str, all_: bool,
                 names: List[str]) -> pa.Table:
    """One set operation; NULLs compare equal (SQL set semantics).  Each
    distinct row is counted on both sides in one pyarrow group_by (which
    groups NULLs together), and the counts decide how often it stays."""
    right = right.rename_columns(names)
    if op == "union":
        out = pa.concat_tables([left, right], promote_options="permissive")
        if not all_:
            out = out.group_by(names, use_threads=False).aggregate([])
        return out
    if op not in ("intersect", "except"):
        raise _not_ported(f"set operation {op}")
    both = pa.concat_tables([
        left.append_column("__l", pa.repeat(pa.scalar(1, pa.int64()),
                                             left.num_rows))
        .append_column("__r", pa.repeat(pa.scalar(0, pa.int64()),
                                        left.num_rows)),
        right.append_column("__l", pa.repeat(pa.scalar(0, pa.int64()),
                                             right.num_rows))
        .append_column("__r", pa.repeat(pa.scalar(1, pa.int64()),
                                        right.num_rows))],
        promote_options="permissive")
    g = both.group_by(names, use_threads=False).aggregate(
        [("__l", "sum"), ("__r", "sum")])
    lc = np.asarray(g["__l_sum"].to_numpy(zero_copy_only=False), np.int64)
    rc = np.asarray(g["__r_sum"].to_numpy(zero_copy_only=False), np.int64)
    if op == "intersect":
        reps = np.minimum(lc, rc) if all_ else ((lc > 0) & (rc > 0))
    else:
        reps = np.maximum(lc - rc, 0) if all_ else ((lc > 0) & (rc == 0))
    take = np.repeat(np.arange(len(lc)), reps.astype(np.int64))
    out = g.select(names).take(pa.array(take, pa.int64()))
    try:
        return out.cast(left.schema)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, ValueError):
        return out
