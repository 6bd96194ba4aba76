"""Query executor (port of `liquid_tpu/sql/exec.py`, aggregate routing).

SQL -> parse -> qualify -> plan -> fused device aggregate -> pa.Table.
A single-table aggregate without GROUP BY goes to the fused scalar path
(`sql/fused_agg.py`); a COUNT(*) with no filter is answered from parquet
metadata, as the reference does.  Every other statement shape -- GROUP
BY, joins, plain SELECT, set operations, CTEs, windows, subqueries --
belongs to slices of the port that are not done yet and raises
NotImplementedError naming the shape.
"""
from __future__ import annotations

from typing import Dict, List

import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast
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


_ARITH = {"+": pc.add, "-": pc.subtract, "*": pc.multiply}


def _project(e: ast.Expr, final: pa.Table):
    """Evaluate a select item over the one-row aggregate table (slot
    columns and literals combined by arithmetic)."""
    if isinstance(e, ast.Column):
        return final.column(e.name).combine_chunks()
    if isinstance(e, ast.Literal):
        return pa.scalar(e.value)
    if isinstance(e, ast.Unary) and e.op == "neg":
        return pc.negate(_project(e.operand, final))
    if isinstance(e, ast.Binary) and e.op in _ARITH:
        return _ARITH[e.op](_project(e.left, final),
                            _project(e.right, final))
    if isinstance(e, ast.Binary) and e.op == "/":
        l, r = _project(e.left, final), _project(e.right, final)
        if pa.types.is_integer(l.type) and pa.types.is_integer(r.type):
            raise _not_ported("integer division in a select item")
        return pc.divide(pc.cast(l, pa.float64()), pc.cast(r, pa.float64()))
    raise _not_ported(f"select item {render(e)!r} over aggregates")


class QueryExecutor:
    def __init__(self, catalog: Dict[str, object]):
        self.catalog = catalog       # name -> ParquetTable

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
        if q.group_by:
            raise _not_ported("GROUP BY (the grouped fused path)")
        if not aggs:
            raise _not_ported("SELECT without aggregates (the classic path)")
        return self._exec_scalar_aggregate(q, aggs)

    def _exec_scalar_aggregate(self, q: ast.Select,
                               aggs: List[ast.Func]) -> pa.Table:
        rel = q.from_
        if not (isinstance(rel, ast.TableRef) and not rel.prefix
                and rel.name in self.catalog):
            raise _not_ported("an aggregate over a join or derived table")
        if any(_contains(it.expr, _SUBQUERY) for it in q.items) or (
                q.where is not None and _contains(q.where, _SUBQUERY)):
            raise _not_ported("subqueries")
        if q.having is not None:
            raise _not_ported("HAVING")
        slots = make_slots(aggs)
        rew_inputs = {s.name: s.input for s in slots if s.input is not None}
        table = self.catalog[rel.name]
        plan = plan_scan_filters(q.where)
        needed: set = set()
        for s in slots:
            if s.input is not None:
                collect_columns(s.input, needed)
        pure_count = (not needed and all(s.kind == "count_star"
                                         for s in slots)
                      and not plan.pushdown and not plan.residual)
        if pure_count:
            # COUNT(*) without a filter: parquet metadata only
            final = pa.table({s.name: pa.array([table.num_rows], pa.int64())
                              for s in slots})
        else:
            from liquid_tpu_torch.sql.fused_agg import try_fused_aggregate
            with TRACER.span("sql.fused_aggregate"):
                final = try_fused_aggregate(table, plan, column_hints(q),
                                            slots, rew_inputs)
        mapping = {s.func: s.name for s in slots}
        out = {}
        for it in q.items:
            name = it.alias or render(it.expr)
            v = _project(substitute(it.expr, mapping), final)
            out[name] = (pa.array([v.as_py()], v.type)
                         if isinstance(v, pa.Scalar) else v)
        result = pa.table(out)
        # ORDER BY over a single row changes nothing; OFFSET/LIMIT apply
        if q.offset:
            result = result.slice(q.offset)
        if q.limit is not None:
            result = result.slice(0, q.limit)
        return result
