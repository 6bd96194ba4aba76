"""Query executor (port of `liquid_tpu/sql/exec.py`, aggregate routing).

SQL -> parse -> qualify -> plan -> fused device aggregate -> pa.Table.

Statements: SELECT, `CREATE VIEW` / `DROP VIEW`, CTEs (statement-scoped
views that shadow a stored view and restore it afterwards), UNION /
INTERSECT / EXCEPT [ALL] (INTERSECT binds tighter) and SELECT without
FROM.  A derived table, or a view, that is a plain projection inlines
into the outer query (`_inline_derived`).

Subqueries: an uncorrelated one becomes a literal (IN -> an `InList`
that keeps its NULLs, EXISTS -> a bool, a scalar subquery -> its value).
A correlated EXISTS / NOT EXISTS / [NOT] IN with one equality
correlation runs as a device existence probe (`fused_star.
build_exist_probe`): on the fact of a star join, or on the one table of
a single-table aggregate (`_plan_exist_probes`).  Any other correlated
subquery raises: its lookup belongs to the classic join path.

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
select (`fused_agg.try_fused_select`).  Every other shape -- outer
joins, a derived table that does not inline, grouping sets, a bare
SELECT over a join, windows, correlated lookups -- belongs to slices of
the port that are not done yet and raises NotImplementedError naming the
shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.eval import Batch, Evaluator
from liquid_tpu_torch.sql.parser import parse_statement
from liquid_tpu_torch.sql.physical import (
    collect_columns, find_aggs, make_slots, render, substitute,
)
from liquid_tpu_torch.sql.planner import (
    SUBQUERY_NODES, and_all, column_hints, plan_scan_filters, split_conjuncts,
    subqueries,
)
from liquid_tpu_torch.sql.qualify import Qualifier, map_expr
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
            ev = Evaluator(Batch({}, 1))
            cols = {}
            for it in q.items:
                v = ev.eval(self._rewrite_subqueries(it.expr))
                cols[it.alias or render(it.expr)] = (
                    pa.array([v.as_py()]) if isinstance(v, pa.Scalar) else v)
            return pa.table(cols)
        if any(_contains(e, ast.WindowFunc) for e in
               [it.expr for it in q.items] + [o.expr for o in q.order_by]):
            raise _not_ported("window functions")
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

    def _exec_plain(self, q: ast.Select) -> pa.Table:
        """A bare SELECT: the fused select over one parquet table."""
        rel = q.from_
        if isinstance(rel, ast.Join):
            raise _not_ported("a SELECT without aggregates over a join (the "
                              "classic join path)")
        if not self._is_table(rel):
            raise _not_ported("a SELECT without aggregates over a derived, "
                              "aliased or view relation (the classic join "
                              "path)")
        scope = self._scope_cols(q)
        q = self._rewrite_query(q, scope, self._rewrite_subqueries(
            q.where, scope))
        from liquid_tpu_torch.sql.fused_agg import try_fused_select
        with TRACER.span("sql.fused_select"):
            return try_fused_select(self, self.catalog[rel.name], q, q.where)

    def _rewrite_query(self, q: ast.Select, scope, where) -> ast.Select:
        """q with `where` and its select items and HAVING rewritten
        (uncorrelated subqueries as literals)."""
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
        rel = q.from_
        star = isinstance(rel, ast.Join)
        if not star and not self._is_table(rel):
            raise _not_ported("an aggregate over a derived table that does "
                              "not inline, an aliased table or a view (the "
                              "classic join path)")
        if any(isinstance(g, ast.GroupingSpec) for g in q.group_by):
            raise _not_ported("GROUPING SETS / ROLLUP / CUBE")
        scope = self._scope_cols(q)
        especs: tuple = ()
        if star:
            # a correlated conjunct stays whole: the star planner takes it
            # as an existence probe on the fact, or names it
            where = and_all([
                c if self._correlated(c, scope)
                else self._rewrite_subqueries(c, scope)
                for c in split_conjuncts(q.where)])
        else:
            where, especs = self._plan_exist_probes(
                q.where, self.catalog[rel.name])
            where = self._rewrite_subqueries(where, scope)
        q = self._rewrite_query(q, scope, where)
        slots = make_slots(aggs)
        group = self._resolve_group_exprs(q)
        key_names = [nm for _, nm in group]
        rew_keys = [ge for ge, _ in group]
        rew_inputs = {s.name: s.input for s in slots if s.input is not None}
        if any(subqueries(e) for e in rew_keys + list(rew_inputs.values())):
            raise _not_ported("a subquery inside a group key or an aggregate "
                              "input")
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
        pure_count = (not needed and not group and not especs
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
                if especs:
                    raise _not_ported("count(DISTINCT) beside an existence "
                                      "probe (the classic path)")
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
                        rew_keys, rew_inputs, q, especs)
        return self._project(q, group, slots, final)

    # -- subqueries --------------------------------------------------------

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

    def _is_correlated(self, sub, scope: frozenset) -> bool:
        if not isinstance(sub, ast.Select) or sub.from_ is None:
            return False
        corr = self._split_correlation(sub, self._scope_cols(sub), scope)
        return bool(corr["eq"] or corr["extra"])

    def _correlated(self, e, scope: frozenset) -> bool:
        """Does a subquery of `e` reference the outer query?"""
        return any(self._is_correlated(s.query, scope)
                   for s in subqueries(e))

    def _rewrite_subqueries(self, e, scope: frozenset = frozenset()):
        """Uncorrelated subqueries -> literals: IN -> InList (its NULLs
        kept: the evaluator applies three-valued IN / NOT IN), EXISTS ->
        a bool, a scalar subquery -> its value.  A correlated one raises:
        its lookup (the reference's CorrLookup) is classic-path work."""
        if e is None:
            return None

        def walk(x):
            if not isinstance(x, SUBQUERY_NODES):
                return None
            if self._is_correlated(x.query, scope):
                raise _not_ported(
                    f"the correlated subquery {_sub_text(x)} (no existence "
                    f"probe takes it; its lookup belongs to the classic "
                    f"join path)")
            if isinstance(x, ast.InSubquery):
                t = self.execute(x.query)
                vals = tuple(ast.Literal(v) for v in
                             dict.fromkeys(t.column(0).to_pylist()))
                return ast.InList(self._rewrite_subqueries(x.operand, scope),
                                  vals, x.negated)
            if isinstance(x, ast.Exists):
                return ast.Literal(self._exists(x.query) != x.negated)
            return ast.Literal(self._scalar_subquery(x.query).as_py())
        return map_expr(e, walk)

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


def _sub_text(x) -> str:
    kind = ("IN" if isinstance(x, ast.InSubquery) else "EXISTS"
            if isinstance(x, ast.Exists) else "scalar")
    sub = x.query
    frm = getattr(sub.from_, "name", type(sub.from_).__name__)
    return f"({kind} over {frm})"


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
    q2.items = [ast.SelectItem(subst(it.expr), it.alias or render(it.expr))
                for it in q.items]
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
