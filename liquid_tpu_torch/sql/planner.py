"""Predicate classification and lineage analysis (plan-time).

Reference behavior:
- `LiquidExpr::try_new` (liquid-cache `src/core/src/cache/liquid_expr.rs`):
  admit only column-vs-literal comparisons, LIKE with extractable
  substring, and boolean literals to encoded evaluation;
  `to_timestamp_seconds(col)` unwrapping is allowed.
- `extract_multi_column_or` (reader/runtime/liquid_predicate.rs:12-43):
  decompose nested OR into per-column predicates for encoded eval.
- `LineageOptimizer` (optimizers/lineage_opt.rs): detect columns used
  ONLY via EXTRACT(year/month/day/dow) or LIKE '%x%' and record squeeze
  hints for them.

Host copy of `liquid_tpu/sql/planner.py` (without the variant-column
hint, whose encoding is not ported): the port imports nothing of the
reference package.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from liquid_tpu_torch.arrays.base import Predicate
from liquid_tpu_torch.cache.expressions import ExtractDate32, SubstringSearch
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.qualify import map_expr

_CMP_FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
_CMP_TO_PRED = {"=": "eq", "<>": "ne", "<": "lt", "<=": "lt_eq",
                ">": "gt", ">=": "gt_eq"}


def split_conjuncts(e: Optional[ast.Expr]) -> List[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.Binary) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    if isinstance(e, ast.Between) and not e.negated:
        return (split_conjuncts(ast.Binary(">=", e.operand, e.low))
                + split_conjuncts(ast.Binary("<=", e.operand, e.high)))
    if isinstance(e, ast.Binary) and e.op == "or":
        hoisted = _hoist_or_common(e)
        if len(hoisted) > 1:
            out: List[ast.Expr] = []
            for h in hoisted:
                out.extend(split_conjuncts(h))
            return out
    return [e]


def and_all(exprs: List[ast.Expr]) -> Optional[ast.Expr]:
    """The conjunction of `exprs` (None for none): `split_conjuncts`'s
    inverse."""
    out = None
    for e in exprs:
        out = e if out is None else ast.Binary("and", out, e)
    return out


SUBQUERY_NODES = (ast.Subquery, ast.InSubquery, ast.Exists)


def subqueries(e: Optional[ast.Expr]) -> List[ast.Expr]:
    """The subquery nodes of `e` that are not inside another subquery."""
    out: List[ast.Expr] = []

    def walk(x):
        if isinstance(x, SUBQUERY_NODES):
            out.append(x)
            return x
        return None
    if e is not None:
        map_expr(e, walk)
    return out


def _flatten_or(e: ast.Expr) -> List[ast.Expr]:
    if isinstance(e, ast.Binary) and e.op == "or":
        return _flatten_or(e.left) + _flatten_or(e.right)
    return [e]


def _hoist_or_common(e: ast.Expr) -> List[ast.Expr]:
    """Factor conjuncts common to every OR branch out of the disjunction:
    `(a AND x AND y) OR (a AND z)` -> `a AND ((x AND y) OR z)`.

    TPC-H q19's three-branch OR repeats `p_partkey = l_partkey` (the join
    key!), `l_shipmode in (...)`, `l_shipinstruct = ...` in every branch;
    without hoisting the join degenerates to a cross product.  (The
    reference inherits this rewrite from DataFusion's expr simplifier.)
    """
    branches = _flatten_or(e)
    if len(branches) < 2:
        return [e]
    sets = [split_conjuncts(b) for b in branches]
    try:
        common = set(sets[0])
        for s in sets[1:]:
            common &= set(s)
    except TypeError:
        return [e]  # unhashable nodes (runtime lookups): no hoisting
    if not common:
        return [e]
    rest = []
    for s in sets:
        rem = [c for c in s if c not in common]
        if not rem:
            return [e]  # one branch is fully common: OR is just the common part
        r = rem[0]
        for c in rem[1:]:
            r = ast.Binary("and", r, c)
        rest.append(r)
    or_part = rest[0]
    for r in rest[1:]:
        or_part = ast.Binary("or", or_part, r)
    return [c for c in sets[0] if c in common] + [or_part]


def _unwrap_column(e: ast.Expr) -> Optional[Tuple[str, str]]:
    """-> (column_name, transform) where transform describes how the
    column was wrapped: "" | "days" (int reinterpreted as date32) |
    "seconds" (int reinterpreted as timestamp-seconds).

    Handles ``col``, ``col::INT::DATE`` (ClickBench q6/q36-42) and
    ``to_timestamp_seconds(col)`` (q18; ref liquid_expr.rs:65-202).
    """
    if isinstance(e, ast.Column):
        return e.name, ""
    if isinstance(e, ast.Cast):
        inner = e.operand
        if e.type_name == "date":
            if isinstance(inner, ast.Cast) and inner.type_name in (
                    "int", "integer", "bigint", "smallint"):
                inner = inner.operand
            if isinstance(inner, ast.Column):
                return inner.name, "days"
        if e.type_name in ("int", "integer", "bigint", "smallint"):
            if isinstance(inner, ast.Column):
                return inner.name, ""
    if isinstance(e, ast.Func) and e.name == "to_timestamp_seconds":
        if len(e.args) == 1 and isinstance(e.args[0], ast.Column):
            return e.args[0].name, "seconds"
    return None


def _literal_value(e: ast.Expr):
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.Unary) and e.op == "neg" and isinstance(e.operand, ast.Literal):
        v = e.operand.value
        return -v if isinstance(v, (int, float)) else None
    if isinstance(e, ast.Cast) and isinstance(e.operand, ast.Literal):
        v = e.operand.value
        if e.type_name == "date" and isinstance(v, str):
            return datetime.date.fromisoformat(v)
        return v
    if isinstance(e, ast.Binary) and e.op in ("+", "-", "*", "/"):
        # constant folding at plan time (the reference inherits this from
        # DataFusion's simplifier): date +/- interval and literal
        # arithmetic -- without it `x < date '1994-01-01' + interval '1'
        # year` can't push down and every block pays a pyarrow fallback
        if isinstance(e.right, ast.Interval):
            base = _literal_value(e.left)
            if isinstance(base, datetime.date) and not isinstance(
                    base, datetime.datetime):
                return _date_plus_interval(
                    base, e.right, -1 if e.op == "-" else 1)
            return None
        lv, rv = _literal_value(e.left), _literal_value(e.right)
        if isinstance(lv, (int, float)) and isinstance(rv, (int, float)) \
                and not isinstance(lv, bool) and not isinstance(rv, bool):
            try:
                if e.op == "/":
                    if rv == 0:
                        return None
                    if isinstance(lv, int) and isinstance(rv, int):
                        # SQL int/int truncates toward zero (matches
                        # Evaluator._divide / DataFusion)
                        q_ = abs(lv) // abs(rv)
                        return -q_ if (lv < 0) != (rv < 0) else q_
                    return lv / rv
                return {"+": lv + rv, "-": lv - rv,
                        "*": lv * rv}[e.op]
            except TypeError:
                return None
    return None


def _date_plus_interval(d: datetime.date, iv: ast.Interval, sign: int):
    n = iv.value * sign
    if iv.unit == "day":
        return d + datetime.timedelta(days=n)
    if iv.unit in ("month", "year"):
        months = n * (12 if iv.unit == "year" else 1)
        total = d.year * 12 + (d.month - 1) + months
        y, m = divmod(total, 12)
        import calendar
        day = min(d.day, calendar.monthrange(y, m + 1)[1])
        return datetime.date(y, m + 1, day)
    return None


def _convert_literal(value, transform: str):
    """Map a literal into the raw column domain for a wrapped column."""
    if transform == "":
        if isinstance(value, datetime.date) and not isinstance(value, datetime.datetime):
            return value  # raw date32 column vs date literal: handled below
        return value
    if transform == "days":
        if isinstance(value, str):
            value = datetime.date.fromisoformat(value)
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        return value
    if transform == "seconds":
        if isinstance(value, str):
            value = datetime.datetime.fromisoformat(value)
        if isinstance(value, datetime.datetime):
            return int(value.replace(tzinfo=datetime.timezone.utc).timestamp())
        return value
    return None


def _norm_date(v):
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return (v - datetime.date(1970, 1, 1)).days
    return v


def like_to_pred(pattern: str, negated: bool = False) -> Optional[Predicate]:
    """LIKE pattern -> encoded predicate when extractable
    (ref ByteViewOperator conversion, operator.rs:40-85)."""
    if "_" in pattern:
        return None
    inner = pattern
    starts = pattern.startswith("%")
    ends = pattern.endswith("%")
    core = pattern.strip("%")
    if "%" in core:
        return None
    if starts and ends:
        return Predicate("not_contains" if negated else "contains", core)
    if negated:
        return None
    if ends and not starts:
        return Predicate("starts_with", core)
    if starts and not ends:
        return Predicate("ends_with", core)
    return Predicate("eq", inner)


def classify_pushdown(e: ast.Expr) -> Optional[List[Tuple[str, Predicate]]]:
    """-> list of (column, predicate) alternatives OR-ed together, or None
    if this conjunct cannot run on encoded data."""
    if isinstance(e, ast.Binary) and e.op == "or":
        l = classify_pushdown(e.left)
        r = classify_pushdown(e.right)
        if l is None or r is None:
            return None
        return l + r
    if isinstance(e, ast.Binary) and e.op in _CMP_TO_PRED:
        lc, rc = _unwrap_column(e.left), _unwrap_column(e.right)
        lv, rv = _literal_value(e.left), _literal_value(e.right)
        if lc is not None and rv is not None:
            col, transform = lc
            op = _CMP_TO_PRED[e.op]
        elif rc is not None and lv is not None:
            col, transform = rc
            op = _CMP_TO_PRED[_CMP_FLIP[e.op]]
            rv = lv
        else:
            return None
        value = _convert_literal(rv, transform)
        if value is None and rv is not None:
            return None
        value = _norm_date(value)
        if isinstance(value, (datetime.datetime,)):
            return None
        return [(col, Predicate(op, value))]
    if isinstance(e, ast.Binary) and e.op == "like":
        if isinstance(e.left, ast.Column) and isinstance(e.right, ast.Literal) \
                and isinstance(e.right.value, str):
            p = like_to_pred(e.right.value)
            if p is not None:
                return [(e.left.name, p)]
        return None
    if isinstance(e, ast.Unary) and e.op == "not":
        inner = e.operand
        if isinstance(inner, ast.Binary) and inner.op == "like" \
                and isinstance(inner.left, ast.Column) \
                and isinstance(inner.right, ast.Literal) \
                and isinstance(inner.right.value, str):
            p = like_to_pred(inner.right.value, negated=True)
            if p is not None:
                return [(inner.left.name, p)]
        return None
    return None


@dataclass
class PushGroup:
    alternatives: List[Tuple[str, Predicate]]
    source: ast.Expr  # original conjunct, for the fallback path


@dataclass
class ScanPlan:
    pushdown: List[PushGroup] = field(default_factory=list)
    residual: List[ast.Expr] = field(default_factory=list)

    @property
    def stats_preds(self) -> List[Tuple[str, Predicate]]:
        """Single-alternative pushdowns usable for row-group pruning."""
        return [g.alternatives[0] for g in self.pushdown
                if len(g.alternatives) == 1]


def plan_scan_filters(where: Optional[ast.Expr]) -> ScanPlan:
    plan = ScanPlan()
    for conj in split_conjuncts(where):
        alts = classify_pushdown(conj)
        if alts is not None:
            plan.pushdown.append(PushGroup(alts, conj))
        else:
            plan.residual.append(conj)
    return plan


# -- lineage analysis (squeeze hints) --------------------------------------

def column_hints(q: ast.Select) -> Dict[str, object]:
    """Columns used ONLY via LIKE '%x%' -> SubstringSearch; columns used
    ONLY via EXTRACT(field) over a raw date column -> ExtractDate32
    (ref ColumnAnnotation::{DatePart,SubstringSearch},
    optimizers/lineage_opt.rs:31-114)."""
    usage: Dict[str, set] = {}

    def walk(e, ctx="other"):
        if e is None:
            return
        if isinstance(e, ast.Column):
            usage.setdefault(e.name, set()).add(ctx)
            return
        if isinstance(e, ast.Binary) and e.op in ("like", "ilike"):
            if isinstance(e.left, ast.Column):
                usage.setdefault(e.left.name, set()).add("like")
                walk(e.right)
                return
        if isinstance(e, ast.Extract):
            if isinstance(e.operand, ast.Column) and e.field in (
                    "year", "month", "day", "dow"):
                usage.setdefault(e.operand.name, set()).add(f"extract:{e.field}")
                return
        for f_ in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f_)
            if isinstance(v, ast.Expr):
                walk(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, ast.Expr):
                        walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, ast.Expr):
                                walk(y)

    walk(q.where)
    for it in q.items:
        walk(it.expr)
    for g in q.group_by:
        walk(g)
    walk(q.having)
    for o in q.order_by:
        walk(o.expr)

    hints: Dict[str, object] = {}
    for col, kinds in usage.items():
        if kinds == {"like"}:
            hints[col] = SubstringSearch()
        elif len(kinds) == 1:
            k = next(iter(kinds))
            if isinstance(k, str) and k.startswith("extract:"):
                hints[col] = ExtractDate32(k.split(":")[1])
    return hints
