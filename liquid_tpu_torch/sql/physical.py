"""Plan helpers shared by the executor and the fused path (port of the
helper half of `liquid_tpu/sql/physical.py`: display names, aggregate
discovery and slotting, expression substitution, column collection).

Host copy: the port imports nothing of the reference package.  The
reference's classic scan loop and aggregators in the same module are
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

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
