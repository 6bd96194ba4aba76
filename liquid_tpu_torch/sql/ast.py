"""SQL AST node definitions.

The liquid-tpu SQL dialect covers the reference's benchmark query sets
(ClickBench 43 queries, TPC-H, TPC-DS core shapes): SELECT with
expressions, WHERE, GROUP BY, HAVING, ORDER BY, LIMIT, JOINs,
aggregates (COUNT/COUNT DISTINCT/SUM/AVG/MIN/MAX), EXTRACT, LIKE,
BETWEEN, IN, CASE, date arithmetic.  The planner consumes these nodes;
there is no dependency on any external SQL engine.

Host copy of `liquid_tpu/sql/ast.py`: the port imports nothing of the
reference package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str
    table: Optional[str] = None


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None | datetime.date


@dataclass(frozen=True)
class Binary(Expr):
    op: str  # + - * / % = <> < <= > >= and or like not_like
    left: Expr
    right: Expr


@dataclass(frozen=True)
class Unary(Expr):
    op: str  # not, neg
    operand: Expr


@dataclass(frozen=True)
class Func(Expr):
    name: str           # lower-cased
    args: Tuple[Expr, ...]
    distinct: bool = False
    star: bool = False  # COUNT(*)


@dataclass(frozen=True)
class WindowFunc(Expr):
    """`func(...) OVER (PARTITION BY ... ORDER BY ... [frame])`.

    Ref: the reference delegates window functions to DataFusion's
    WindowAggExec; we implement the standard set (row_number, rank,
    dense_rank, ntile, lag, lead, first_value, last_value, and the
    framed aggregates sum/count/avg/min/max) in liquid_tpu_torch.sql.window.

    Field layout is deliberately FLAT (parallel tuples, not OrderItem
    objects) so the generic dataclass walkers (map_expr, collect_columns,
    find_aggs) traverse every embedded Expr without special cases.
    `frame` is `(unit, start, end)` with unit in {"rows", "range"} and
    bounds like "unbounded_preceding" / "current_row" / "3_preceding" /
    "2_following" / "unbounded_following"; None means the SQL default
    (RANGE UNBOUNDED PRECEDING..CURRENT ROW when ORDER BY is present,
    else the whole partition).
    """

    func: Func
    partition_by: Tuple[Expr, ...] = ()
    order_exprs: Tuple[Expr, ...] = ()
    order_desc: Tuple[bool, ...] = ()
    order_nulls_first: Tuple[Optional[bool], ...] = ()
    frame: Optional[Tuple[str, str, str]] = None


@dataclass(frozen=True)
class GroupingSpec(Expr):
    """GROUP BY ROLLUP(...) / CUBE(...) / GROUPING SETS(...).

    Ref: the reference gets grouping sets from DataFusion's logical
    planner (TPC-DS q18/q22/q27/q36/q67/q86); liquid_tpu expands them in
    the executor (one grouped aggregation per set, excluded keys NULLed,
    `grouping(col)` folded to 0/1 per set).
    """

    kind: str                                  # rollup | cube | sets
    exprs: Tuple[Expr, ...] = ()               # rollup/cube key list
    sets: Tuple[Tuple[Expr, ...], ...] = ()    # explicit GROUPING SETS


@dataclass(frozen=True)
class Extract(Expr):
    field: str  # year month day dow minute hour ...
    operand: Expr


@dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    else_: Optional[Expr]
    operand: Optional[Expr] = None


@dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    items: Tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str


@dataclass(frozen=True)
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass(frozen=True)
class Interval(Expr):
    value: int
    unit: str  # day month year


@dataclass(frozen=True, eq=False)
class Subquery(Expr):
    query: "Select"


@dataclass(frozen=True, eq=False)
class Exists(Expr):
    query: "Select"
    negated: bool = False


@dataclass(frozen=True, eq=False)
class InSubquery(Expr):
    operand: Expr
    query: "Select"
    negated: bool = False


@dataclass(frozen=True)
class Star(Expr):
    table: Optional[str] = None


@dataclass(frozen=True, eq=False)
class CorrLookup(Expr):
    """Runtime node produced by decorrelating a correlated subquery
    (EXISTS / IN / scalar aggregate): a per-row lookup into a
    precomputed inner table keyed by the equality-correlated columns.

    `kind`: "exists" (boolean membership, optionally post-filtered by
    `extra`, a residual correlated predicate over inner columns and
    `__outer{i}` stand-ins for `outer_refs`) or "scalar" (map the key to
    the inner table's `__v` aggregate; missing key -> NULL).
    identity-eq on purpose: carries an unhashable pa.Table.
    """

    keys: Tuple[Expr, ...]        # outer key expressions
    key_cols: Tuple[str, ...]     # inner table key column names
    kind: str                     # "exists" | "scalar"
    table: object                 # pa.Table (precomputed inner result)
    negated: bool = False
    outer_refs: Tuple[Expr, ...] = ()
    extra: Optional[Expr] = None


@dataclass
class SetOp:
    """UNION / INTERSECT / EXCEPT [ALL] chain; `ops[i]`/`all_flags[i]`
    describe the operator BETWEEN members[i] and members[i+1].
    INTERSECT binds tighter than UNION/EXCEPT (SQL standard); the
    remainder folds left-associatively (a UNION b UNION ALL c dedups
    {a,b} then appends c).  Trailing `order_by`/`limit`/`offset` apply
    to the combined result."""

    members: List["Select"] = field(default_factory=list)
    all_flags: List[bool] = field(default_factory=list)
    order_by: List["OrderItem"] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ops: List[str] = field(default_factory=list)  # union|intersect|except


# -- relations -------------------------------------------------------------

@dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None
    #: column-name prefix ("<alias>__") assigned by the qualification
    #: pass to aliased tables so self-joins get distinct column names
    prefix: Optional[str] = None


@dataclass(frozen=True)
class Join:
    left: object            # TableRef | Join | SubqueryRel
    right: object
    kind: str               # inner | left | right | full | cross
    on: Optional[Expr]      # join condition


@dataclass(frozen=True)
class SubqueryRel:
    query: "Select"
    alias: str
    #: column-name prefix ("<alias>__") assigned by the qualification
    #: pass when the derived table's output names collide with another
    #: relation in the same FROM (e.g. TPC-DS q44's asceding/descending)
    prefix: Optional[str] = None


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class Select:
    items: List[SelectItem] = field(default_factory=list)
    from_: Optional[object] = None      # TableRef | Join | SubqueryRel
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    #: WITH-clause common table expressions: [(name, Select)]
    ctes: List = field(default_factory=list)
