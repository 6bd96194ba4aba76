"""Expression evaluation over arrow column batches (host copy of
`liquid_tpu/sql/eval.py`).

pyarrow compute kernels with DataFusion semantics (Kleene logic, SQL
type coercion).  The fused paths evaluate their post-projection, HAVING
and ORDER BY over the aggregate result here; the classic path evaluates
residual filters, projections and aggregate inputs over decoded blocks
and joined tables.  A scalar subquery calls back into the executor; a
decorrelated subquery (`ast.CorrLookup`) is a lookup into its
precomputed inner table by a pyarrow join.  `variant_get` reads a typed
JSON path: a field of the struct the scan read from a shredded variant
entry, else parsed from the JSON text; `variant_pretty` and
`variant_to_json` re-serialize the documents.
"""
from __future__ import annotations

import datetime
import json
from typing import Dict, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast

_VARIANT_TYPE_ALIASES = {
    "int64": "int64", "int": "int64", "bigint": "int64", "integer": "int64",
    "float64": "float64", "double": "float64", "float": "float64",
    "utf8": "utf8", "string": "utf8", "varchar": "utf8", "text": "utf8",
    "bool": "bool", "boolean": "bool", "variant": "variant", "json": "variant",
}


def normalize_variant_type(t: str) -> str:
    """A variant_get type argument -> one of `arrays.variant.PATH_TYPES`
    (unknown names read the subtree as JSON)."""
    return _VARIANT_TYPE_ALIASES.get(str(t).lower(), "variant")

class Batch:
    """Named arrow arrays of equal length (a materialized block or the
    aggregate result)."""

    def __init__(self, columns: Dict[str, pa.Array], length: int):
        self.columns = columns
        self.length = length

    @classmethod
    def from_table(cls, t: pa.Table) -> "Batch":
        return cls({n: t.column(n).combine_chunks() for n in t.column_names},
                   t.num_rows)

    def to_table(self) -> pa.Table:
        return pa.table(self.columns)


def _like_to_regex(pattern: str) -> str:
    import re as _re
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(_re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _as_array(v, length: int) -> pa.Array:
    if isinstance(v, pa.Array):
        return v
    if isinstance(v, pa.ChunkedArray):
        return v.combine_chunks()
    if isinstance(v, pa.Scalar):
        return pa.repeat(v, length) if length else pa.array([], v.type)
    return pa.repeat(pa.scalar(v), length)


def _lit_scalar(value):
    if isinstance(value, datetime.date) and not isinstance(value, datetime.datetime):
        return pa.scalar(value, pa.date32())
    return pa.scalar(value)


class Evaluator:
    """Evaluates ast.Expr -> pa.Array | pa.Scalar over a Batch."""

    def __init__(self, batch: Batch, scalar_subquery_exec=None):
        self.b = batch
        self._subq = scalar_subquery_exec

    def arr(self, e: ast.Expr) -> pa.Array:
        return _as_array(self.eval(e), self.b.length)

    def eval(self, e: ast.Expr):
        if isinstance(e, ast.Column):
            col = self.b.columns.get(e.name)
            if col is None and e.table:
                col = self.b.columns.get(f"{e.table}.{e.name}")
            if col is None:
                raise KeyError(f"unknown column {e.name!r}; have {list(self.b.columns)[:8]}")
            if pa.types.is_dictionary(col.type):
                col = col.cast(col.type.value_type)
            return col
        if isinstance(e, ast.Literal):
            return _lit_scalar(e.value)
        if isinstance(e, ast.Interval):
            return e
        if isinstance(e, ast.Binary):
            return self._binary(e)
        if isinstance(e, ast.Unary):
            if e.op == "not":
                return pc.invert(self.arr(e.operand))
            v = self.eval(e.operand)
            if isinstance(v, pa.Scalar):
                return pa.scalar(-v.as_py())
            return pc.negate(v)
        if isinstance(e, ast.IsNull):
            v = self.arr(e.operand)
            return pc.is_valid(v) if e.negated else pc.is_null(v)
        if isinstance(e, ast.InList):
            v = self.arr(e.operand)
            items = [self.eval(i) for i in e.items]
            py = [i.as_py() if isinstance(i, pa.Scalar) else i for i in items]
            has_null = any(x is None for x in py)
            vs = pa.array([x for x in py if x is not None])
            if len(vs) == 0:
                # IN () -> FALSE/NULL; NOT IN () -> TRUE/NULL per operand
                base = pa.array(np.zeros(self.b.length, bool))
                out = pc.if_else(pc.is_valid(v), base, pa.scalar(None, pa.bool_()))
            else:
                out = pc.is_in(
                    v, value_set=vs.cast(v.type) if vs.type != v.type else vs)
                # NULL operand -> NULL (is_in says False)
                out = pc.if_else(pc.is_valid(v), out,
                                 pa.scalar(None, pa.bool_()))
            if has_null:
                # three-valued logic: a NULL in the list turns every
                # non-match into UNKNOWN (x IN (1, NULL): TRUE or NULL;
                # NOT IN: FALSE or NULL -- never TRUE)
                out = pc.if_else(pc.fill_null(out, False), out,
                                 pa.scalar(None, pa.bool_()))
            return pc.invert(out) if e.negated else out
        if isinstance(e, ast.Between):
            v = self.eval(e.operand)
            lo, hi = self.eval(e.low), self.eval(e.high)
            v, lo = _coerce(v, lo)
            v, hi = _coerce(v, hi)
            out = pc.and_kleene(pc.greater_equal(v, lo), pc.less_equal(v, hi))
            return pc.invert(out) if e.negated else out
        if isinstance(e, ast.Case):
            return self._case(e)
        if isinstance(e, ast.Cast):
            return self._cast(e)
        if isinstance(e, ast.Extract):
            return self._extract(e.field, e.operand)
        if isinstance(e, ast.Func):
            return self._func(e)
        if isinstance(e, ast.Subquery):
            if self._subq is None:
                raise NotImplementedError("a scalar subquery here")
            return self._subq(e.query)
        if isinstance(e, ast.CorrLookup):
            return self._corr_lookup(e)
        raise NotImplementedError(f"eval {type(e).__name__}")

    def _corr_lookup(self, e: ast.CorrLookup):
        """A decorrelated subquery: the outer rows' equality keys joined
        (pyarrow) against the precomputed inner table.  "scalar" maps a
        row to the inner `__v` of its key (no match: NULL); "exists" marks
        the rows with a match, after the `extra` residual over the matched
        pairs.  A NULL key matches nothing, on either side."""
        n = self.b.length
        kn = [f"__k{i}" for i in range(len(e.keys))]
        kcols = list(e.key_cols)
        inner = e.table
        outer_cols = {"__rowid": pa.array(np.arange(n, dtype=np.int64))}
        icols = {}
        for name, k, kc in zip(kn, e.keys, kcols):
            a, b = _join_pair(_plain(self.arr(k)),
                              _plain(inner.column(kc).combine_chunks()))
            outer_cols[name], icols[kc] = a, b
        outer = pa.table(outer_cols)
        outer = outer.filter(_all_valid(outer, kn))
        icols["__idx"] = pa.array(np.arange(inner.num_rows, dtype=np.int64))
        itab = pa.table(icols)
        itab = itab.filter(_all_valid(itab, kcols))
        if itab.num_rows > 4 * outer.num_rows:
            # a lookup per scanned block: hash the block's few keys, not
            # the whole inner table, and join what can match
            itab = itab.filter(pc.is_in(itab[kcols[0]],
                                        value_set=outer[kn[0]]))
        if e.kind == "scalar":
            m = outer.join(itab, keys=kn, right_keys=kcols,
                           join_type="inner", use_threads=False)
            full = np.full(n, -1, dtype=np.int64)
            full[np.asarray(m["__rowid"])] = np.asarray(m["__idx"])
            idx = pa.array(full, pa.int64(), mask=full < 0)
            return inner.column("__v").combine_chunks().take(idx)
        m = outer.join(itab, keys=kn, right_keys=kcols, join_type="inner",
                       use_threads=False)
        rowid = np.asarray(m["__rowid"].combine_chunks(), np.int64)
        if e.extra is not None and m.num_rows:
            take = pa.array(np.asarray(m["__idx"].combine_chunks()),
                            pa.int64())
            cols = {c: inner.column(c).combine_chunks().take(take)
                    for c in inner.column_names}
            for i, r in enumerate(e.outer_refs):
                cols[f"__outer{i}"] = self.arr(r).take(
                    pa.array(rowid, pa.int64()))
            keep = Evaluator(Batch(cols, m.num_rows), self._subq).arr(
                e.extra)
            rowid = rowid[np.asarray(pc.fill_null(keep.cast(pa.bool_()),
                                                  False))]
        hit = np.zeros(n, dtype=bool)
        hit[rowid] = True
        return pa.array(~hit if e.negated else hit)

    # -- pieces ------------------------------------------------------------

    def _binary(self, e: ast.Binary):
        op = e.op
        if op == "and":
            return pc.and_kleene(self.arr(e.left), self.arr(e.right))
        if op == "or":
            return pc.or_kleene(self.arr(e.left), self.arr(e.right))
        l = self.eval(e.left)
        r = self.eval(e.right)
        if op in ("like", "ilike"):
            pat = r.as_py() if isinstance(r, pa.Scalar) else r
            return pc.match_like(_as_array(l, self.b.length), pat,
                                 ignore_case=(op == "ilike"))
        if op == "||":
            return pc.binary_join_element_wise(
                _as_array(l, self.b.length).cast(pa.string()),
                _as_array(r, self.b.length).cast(pa.string()), "")
        # date +/- interval
        if isinstance(r, ast.Interval):
            return _date_arith(l, r, op)
        l, r = _coerce(l, r)
        if _is_null_typed(l) or _is_null_typed(r):
            # NULL literal operand (e.g. empty scalar subquery): SQL
            # comparisons/arithmetic with NULL are NULL
            return pa.nulls(self.b.length, pa.bool_()
                            if op in ("=", "<>", "<", "<=", ">", ">=")
                            else pa.float64())
        fns = {"+": pc.add_checked, "-": pc.subtract_checked,
               "*": pc.multiply_checked, "/": _divide, "%": _modulo,
               "=": pc.equal, "<>": pc.not_equal, "<": pc.less,
               "<=": pc.less_equal, ">": pc.greater, ">=": pc.greater_equal}
        if op in ("+", "-", "*") and (_is_float(l) or _is_float(r)):
            fns = dict(fns)
            fns.update({"+": pc.add, "-": pc.subtract, "*": pc.multiply})
        return fns[op](l, r)

    def _case(self, e: ast.Case):
        length = self.b.length
        if e.operand is not None:
            op_arr = self.eval(e.operand)
            conds = [pc.equal(_as_array(op_arr, length), self.eval(c))
                     for c, _ in e.whens]
        else:
            conds = [self.arr(c) for c, _ in e.whens]
        vals = [self.eval(v) for _, v in e.whens]
        out = (self.eval(e.else_) if e.else_ is not None
               else pa.scalar(None, _result_type(vals)))
        out = _as_array(out, length)
        for cond, val in reversed(list(zip(conds, vals))):
            val_arr = _as_array(val, length)
            if val_arr.type != out.type:
                val_arr, out = _coerce(val_arr, out)
            out = pc.if_else(pc.fill_null(cond, False), val_arr, out)
        return out

    def _cast(self, e: ast.Cast):
        v = self.eval(e.operand)
        t = {"int": pa.int32(), "integer": pa.int32(), "bigint": pa.int64(),
             "smallint": pa.int16(), "tinyint": pa.int8(),
             "float": pa.float32(), "real": pa.float32(),
             "double": pa.float64(), "decimal": pa.float64(),
             "numeric": pa.float64(),
             "varchar": pa.string(), "text": pa.string(), "string": pa.string(),
             "date": pa.date32(), "timestamp": pa.timestamp("s"),
             "boolean": pa.bool_(), "bool": pa.bool_()}[e.type_name]
        if isinstance(v, pa.Scalar):
            pv = v.as_py()
            if pv is None:
                return pa.scalar(None, t)
            # SQL casts string literals to temporal types by ISO parse
            # (pa.scalar alone refuses str -> date32)
            if isinstance(pv, str) and pa.types.is_date(t):
                import datetime as _dt
                pv = _dt.date.fromisoformat(pv)
            elif isinstance(pv, str) and pa.types.is_timestamp(t):
                import datetime as _dt
                pv = _dt.datetime.fromisoformat(pv)
            return pa.scalar(pv, t)
        if pa.types.is_date32(t) and pa.types.is_integer(v.type):
            # N::DATE = days since epoch (DataFusion semantics)
            return v.cast(pa.int32()).view(pa.date32())
        return v.cast(t)

    def _extract(self, field: str, operand: ast.Expr):
        v = self.arr(operand)
        if pa.types.is_integer(v.type):
            # bare ints are epoch seconds in the benchmark schemas
            v = v.cast(pa.int64()).view(pa.timestamp("s"))
        f = field.lower()
        fns = {"year": pc.year, "month": pc.month, "day": pc.day,
               "hour": pc.hour, "minute": pc.minute, "second": pc.second,
               "dow": pc.day_of_week, "doy": pc.day_of_year,
               "week": pc.iso_week, "quarter": pc.quarter}
        if f == "dow":
            # DataFusion date_part('dow'): Sunday = 0; arrow day_of_week:
            # Monday=0..Sunday=6 -> shift
            dow = pc.day_of_week(v, count_from_zero=True, week_start=7)
            return dow.cast(pa.int32())
        out = fns[f](v)
        return out.cast(pa.int32()) if out.type != pa.int32() else out

    def _func(self, e: ast.Func):
        name = e.name
        if name == "to_timestamp_seconds":
            v = self.arr(e.args[0])
            return v.cast(pa.int64()).view(pa.timestamp("s"))
        if name in ("lower", "upper", "length", "trim", "ltrim", "rtrim",
                    "reverse"):
            fn = {"lower": pc.utf8_lower, "upper": pc.utf8_upper,
                  "length": pc.utf8_length, "trim": pc.utf8_trim_whitespace,
                  "ltrim": pc.utf8_ltrim_whitespace,
                  "rtrim": pc.utf8_rtrim_whitespace,
                  "reverse": pc.utf8_reverse}[name]
            return fn(self.arr(e.args[0]))
        if name == "substring" or name == "substr":
            v = self.arr(e.args[0])
            if pa.types.is_null(v.type):
                # empty aggregation results carry null-typed key columns
                return pa.nulls(len(v), pa.string())
            start = self.eval(e.args[1]).as_py()
            length = self.eval(e.args[2]).as_py() if len(e.args) > 2 else None
            stop = None if length is None else start - 1 + length
            return pc.utf8_slice_codeunits(v, max(start - 1, 0), stop)
        if name in ("left",):
            v = self.arr(e.args[0])
            n = self.eval(e.args[1]).as_py()
            return pc.utf8_slice_codeunits(v, 0, n)
        if name == "coalesce":
            args = [self.arr(a) for a in e.args]
            # an empty relation's columns are null-typed (the outer side
            # of a join with nothing on it): they take the others' type
            typed = [a.type for a in args if not pa.types.is_null(a.type)]
            if typed:
                args = [a.cast(typed[0]) if pa.types.is_null(a.type) else a
                        for a in args]
            out = args[0]
            for a in args[1:]:
                out = pc.coalesce(out, a)
            return out
        if name == "abs":
            return pc.abs(self.arr(e.args[0]))
        if name == "round":
            nd = self.eval(e.args[1]).as_py() if len(e.args) > 1 else 0
            return pc.round(self.arr(e.args[0]), ndigits=nd)
        if name == "date_trunc":
            unit = self.eval(e.args[0]).as_py()
            v = self.arr(e.args[1])
            if pa.types.is_integer(v.type):
                v = v.cast(pa.int64()).view(pa.timestamp("s"))
            return pc.floor_temporal(v, unit=unit)
        if name == "strpos" or name == "position":
            v = self.arr(e.args[0])
            needle = self.eval(e.args[1]).as_py()
            return pc.add(pc.find_substring(v, needle), 1)
        if name == "regexp_replace":
            v = self.arr(e.args[0])
            pat = self.eval(e.args[1]).as_py()
            rep = self.eval(e.args[2]).as_py()
            # SQL regexp_replace replaces the FIRST match unless 'g' flag
            flags = self.eval(e.args[3]).as_py() if len(e.args) > 3 else ""
            n = -1 if "g" in flags else 1
            return pc.replace_substring_regex(v, pat, rep, max_replacements=n)
        if name == "concat":
            args = [self.arr(a).cast(pa.string()) for a in e.args]
            return pc.binary_join_element_wise(*args, "")
        if name == "variant_get":
            return self._variant_get(e)
        if name in ("variant_pretty", "variant_to_json"):
            from liquid_tpu_torch.arrays import variant as vlib
            docs = vlib.parse_docs(self.arr(e.args[0]))
            if name == "variant_pretty":
                out = [None if d is None else json.dumps(
                    d, indent=2, ensure_ascii=False) for d in docs]
            else:
                out = [None if d is None else json.dumps(
                    d, separators=(",", ":"), ensure_ascii=False)
                    for d in docs]
            return pa.array(out, type=pa.string())
        raise NotImplementedError(f"function {name}")

    def _variant_get(self, e: ast.Func):
        """variant_get(col, 'path' [, type]): the struct field the scan
        read for (path, type) from a shredded variant entry, else the path
        parsed from the JSON text."""
        from liquid_tpu_torch.arrays import variant as vlib
        path = self.eval(e.args[1]).as_py()
        type_name = normalize_variant_type(
            self.eval(e.args[2]).as_py()) if len(e.args) > 2 else "variant"
        v = self.arr(e.args[0])
        if pa.types.is_struct(v.type):
            idx = v.type.get_field_index(vlib.field_name(path, type_name))
            if idx >= 0:
                return v.field(idx)
        docs = vlib.parse_docs(v)
        return vlib.extract_paths(docs, [(path, type_name)]).field(0)


def _plain(a: pa.Array) -> pa.Array:
    return a.cast(a.type.value_type) if pa.types.is_dictionary(a.type) else a


def _join_pair(a: pa.Array, b: pa.Array):
    """Two join-key columns cast to one type (the join compares values of
    one type): both numeric -> int64, or float64 when either is a float."""
    if a.type == b.type:
        return a, b
    num = (pa.types.is_integer, pa.types.is_floating)
    if any(f(a.type) for f in num) and any(f(b.type) for f in num):
        t = pa.float64() if (pa.types.is_floating(a.type)
                             or pa.types.is_floating(b.type)) else pa.int64()
        return a.cast(t), b.cast(t)
    return a.cast(b.type), b


def _all_valid(t: pa.Table, names) -> pa.Array:
    ok = pa.array(np.ones(t.num_rows, dtype=bool))
    for nm in names:
        ok = pc.and_(ok, pc.is_valid(t[nm]))
    return ok


def _is_null_typed(v) -> bool:
    t = getattr(v, "type", None)
    return t is not None and pa.types.is_null(t)


def _is_float(v) -> bool:
    t = v.type if isinstance(v, (pa.Array, pa.Scalar, pa.ChunkedArray)) else None
    return t is not None and pa.types.is_floating(t)


def _divide(l, r):
    # SQL: int/int is integer division in DataFusion; float/any is float.
    # Division by zero yields NULL (not an error): vectorized conjunct
    # evaluation cannot short-circuit `x > 0 AND y / x > c`-shaped
    # predicates (TPC-DS q34), so a raising kernel would abort queries
    # that are well-defined under row-at-a-time semantics.
    lt = l.type if isinstance(l, (pa.Array, pa.Scalar)) else None
    rt = r.type if isinstance(r, (pa.Array, pa.Scalar)) else None
    if lt and rt and pa.types.is_integer(lt) and pa.types.is_integer(rt):
        if isinstance(r, pa.Scalar):
            if not r.is_valid or r.as_py() == 0:
                return pa.scalar(None, lt)
            return pc.divide_checked(l, r)
        zero = pc.equal(r, 0)
        safe = pc.if_else(pc.fill_null(zero, False), pa.scalar(1, r.type), r)
        out = pc.divide_checked(l, safe)
        return pc.if_else(pc.fill_null(zero, False),
                          pa.scalar(None, out.type), out)
    return pc.divide(l, r)


def _modulo(l, r):
    if hasattr(pc, "modulo"):
        return pc.modulo(l, r)
    ln = l.as_py() if isinstance(l, pa.Scalar) else np.asarray(l)
    rn = r.as_py() if isinstance(r, pa.Scalar) else np.asarray(r)
    # SQL modulo takes the DIVIDEND's sign (np.mod takes the divisor's):
    # -7 % 3 = -1 per DataFusion/Postgres
    out = np.fmod(ln, rn)
    if np.ndim(out) == 0:
        return pa.scalar(out.item())
    return pa.array(out)


def _rank(t: pa.DataType) -> int:
    if pa.types.is_floating(t):
        return 3
    if pa.types.is_decimal(t):
        return 2
    return 1


def _coerce(l, r):
    """SQL binary coercion: promote to the wider type."""
    lt = l.type if isinstance(l, (pa.Array, pa.Scalar)) else None
    rt = r.type if isinstance(r, (pa.Array, pa.Scalar)) else None
    if lt is None or rt is None or lt.equals(rt):
        return l, r
    # date vs timestamp / string literals
    if pa.types.is_date32(lt) and pa.types.is_string(rt):
        return l, pa.scalar(datetime.date.fromisoformat(r.as_py()), pa.date32())
    if pa.types.is_string(lt) and pa.types.is_date32(rt):
        return pa.scalar(datetime.date.fromisoformat(l.as_py()), pa.date32()), r
    if pa.types.is_timestamp(lt) and pa.types.is_date32(rt):
        return l, r.cast(pa.timestamp(lt.unit))
    if pa.types.is_date32(lt) and pa.types.is_timestamp(rt):
        return l.cast(pa.timestamp(rt.unit)), r
    num_l = pa.types.is_integer(lt) or pa.types.is_floating(lt)
    num_r = pa.types.is_integer(rt) or pa.types.is_floating(rt)
    if num_l and num_r:
        if _rank(lt) == _rank(rt):
            # both ints or both floats: widen to 64-bit
            target = (pa.float64() if pa.types.is_floating(lt)
                      else (pa.uint64() if (pa.types.is_unsigned_integer(lt)
                                            and pa.types.is_unsigned_integer(rt))
                            else pa.int64()))
        else:
            target = pa.float64()
        return _safe_cast(l, target), _safe_cast(r, target)
    return l, r


def _safe_cast(v, t):
    if isinstance(v, pa.Scalar):
        return pa.scalar(v.as_py(), t)
    return v.cast(t)


def _result_type(vals):
    for v in vals:
        if isinstance(v, (pa.Array, pa.Scalar)):
            return v.type
    return pa.int64()


def _date_arith(l, interval: ast.Interval, op: str):
    assert op in ("+", "-")
    n = interval.value if op == "+" else -interval.value
    if interval.unit in ("day",):
        if isinstance(l, pa.Scalar) and pa.types.is_date32(l.type):
            return pa.scalar(l.as_py() + datetime.timedelta(days=n), pa.date32())
        return pc.add(l, pa.scalar(n * 86400_000_000_000, pa.duration("ns")))
    if interval.unit in ("month", "year"):
        months = n * (12 if interval.unit == "year" else 1)
        if isinstance(l, pa.Scalar) and pa.types.is_date32(l.type):
            d = l.as_py()
            total = d.year * 12 + (d.month - 1) + months
            y, m = divmod(total, 12)
            import calendar
            day = min(d.day, calendar.monthrange(y, m + 1)[1])
            return pa.scalar(datetime.date(y, m + 1, day), pa.date32())
    raise NotImplementedError(f"interval {interval.unit}")
