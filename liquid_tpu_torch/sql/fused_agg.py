"""Fused device scan -> filter -> aggregate (port of
`liquid_tpu/sql/fused_agg.py`, scalar and grouped halves).

A single-table aggregate runs as one device program straight from the
cache's resident encodings:

    bit-planes / ALP integer lanes / linear residuals (stacked per column)
        -> packed interval predicates on the planes (CUDA kernel K1)
        -> on-device value decode (unpack + reference add, ALP scale)
        -> null-aware expression evaluation in i64 / f64 lanes
        -> reductions: scalar, or grouped by direct addressing (exact
           integer sums through CUDA kernel K2) or by the hash ladder
        -> an optional in-program top-k for ORDER BY <agg> LIMIT k

and ONE device -> host fetch returns the packed results.  The reference
jit-compiles this program per query shape; the port runs it eagerly and
keeps the reference's per-table plan cache, so a warm query skips
planning and every upload.

Supported shape (anything else returns None, the reason counted in
`STATS`, and the classic path in `sql/exec.py` takes the query):
- single parquet source; WHERE a conjunction of column-vs-literal
  comparisons (OR groups allowed; a string column's comparison becomes a
  per-block verdict LUT over its dictionary codes) plus residual
  conditions, numeric or string (=, <>, IN, LIKE on a dictionary column
  resolve to sets of ids in the column's sorted global vocabulary),
- GROUP BY numeric, date, bool or string columns, numeric expressions
  of them (CASE, extract, date_trunc, to_timestamp_seconds among them),
  and string-valued expressions of ONE string column (evaluated over its
  vocabulary on the host),
- aggregates count(*)/count/sum/avg/min/max/stddev/var over + - * /
  arithmetic of numeric columns and literals; count and min/max of a
  string column; count(DISTINCT column) (sorted pairs, the chained
  two-level hash or the host fold, below),
- every touched block resident as MEMORY_LIQUID primitive / linear /
  float / byte-view.
The star-join fact program (`sql/fused_star.py`) is this program with
dimension probes added: `probe_dims` maps each row to its dimension row j
through a direct-address index table (or a sorted chain index for a
two-column key), "pay" columns read a dimension's
decoded payload through j, and a functional-dependency plan (`_Plan.fd`)
reduces on one representative key -- the probe index j itself, or a
dimension key value -- and re-attaches the other keys by gathers over the
packed output rows.
Existence probes (`exist_probes`: EXISTS / NOT EXISTS / [NOT] IN over a
per-key count table) run in the same program, on a star's fact or on a
single table.  A bare single-table SELECT ... ORDER BY ... LIMIT picks
its rows here too (`try_fused_select`).
Not ported yet: functional-dependency key reduction on a single table,
grouping sets.
"""
from __future__ import annotations

import numbers
import re
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from liquid_tpu_torch.arrays.base import BLOCK_ROWS, Predicate
from liquid_tpu_torch.arrays.byteview import LiquidByteViewArray
from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray
from liquid_tpu_torch.arrays.linear import LiquidLinearArray, linear_term
from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
from liquid_tpu_torch.cache.core import MEMORY_LIQUID
from liquid_tpu_torch.device import u64_to_i64, words_to_tensor, wrap_i64
from liquid_tpu_torch.ops import bitpack as bp
from liquid_tpu_torch.ops import bitpack_cuda
from liquid_tpu_torch.ops import floatbits
from liquid_tpu_torch.ops import grouphist as gh
from liquid_tpu_torch.ops import hashagg as hops
from liquid_tpu_torch.ops import mask as mops
from liquid_tpu_torch.ops.groupby import scalar_reduce
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.utils.tracing import COPIES, TRACER, to_device, to_host

_U64MAX = (1 << 64) - 1
_W = BLOCK_ROWS // 32

#: host-driven retry ladder for the grouped hash table: (slots, salt);
#: every stage is exact, a dirty stage retries on the next
_STAGES = ((1 << 13, 0x9E3779B97F4A7C15),
           (1 << 17, 0xC2B2AE3D27D4EB4F),
           (1 << 20, 0x165667B19E3779F9),
           (1 << 22, 0x27D4EB2F165667C5))

#: the ladder of the device count(DISTINCT) routes only: a level-1 table
#: keyed by (keys, d) can hold about as many groups as rows scanned
_STAGES_XL = _STAGES + ((1 << 23, 0x94D049BB133111EB),)

#: module counters (the reference's keys: tests and runs read the route);
#: fused_pallas counts grouped runs routed through K2, star_queries the
#: star joins of `sql/fused_star.py`, fused_selects the fused bare
#: SELECTs; distinct_sort, distinct_chained and distinct_fold count the
#: count(DISTINCT) routes (sorted pairs, the chained two-level hash, the
#: host fold)
STATS = {"fused_queries": 0, "fused_grouped": 0, "fused_scalar": 0,
         "fused_bailouts": 0, "fused_retries": 0, "fused_pallas": 0,
         "star_queries": 0, "star_bailouts": 0, "star_dup_bails": 0,
         "fused_selects": 0, "select_bailouts": 0, "distinct_sort": 0,
         "distinct_chained": 0, "distinct_fold": 0,
         # the star route's caches (`sql/fused_star.py`): plan-cache hits,
         # builds evicted to make room for another, and cached plans
         # dropped with a build they pin
         "star_plan_hits": 0, "star_build_evictions": 0,
         "star_plans_dropped": 0,
         # constants (IR literals, IN lists, bounds) a planner placed on
         # the card, and uploads made while a program was being enqueued
         # (`_issue`): 0 on a cached plan
         "plan_consts": 0, "issue_uploads": 0}

_AGG_KINDS = frozenset({"count_star", "count", "sum", "avg", "min", "max",
                        "stddev", "var"})


class _Bail(NotImplementedError):
    """Unsupported shape.  The reference falls back to its classic scan
    path here; the port has none yet, so the bail reaches the caller."""


class KindsWithTypes(dict):
    """col -> kind mapping that also resolves arrow types: `_compile_expr`
    consults ``arrow_type(col)`` to validate value-preserving casts
    (``::date`` passes only over date32 or integer images)."""

    def __init__(self, kinds, typeres):
        super().__init__(kinds)
        self._typeres = typeres

    def arrow_type(self, c):
        return self._typeres(c)


# -- expression IR -------------------------------------------------------------
#
# Nodes carry their dtype ("i64" | "f64"); casts are explicit.
#   ("col", name, dtype)   ("lit", value, dtype)   ("bin", op, dtype, l, r)
#   ("neg", dtype, x)      ("cast", dtype, x)
#   ("bin", "fdiv" | "mod", "i64", l, r)   floor division / floor modulo
#   ("where", dtype, cond, t, f)  CASE: the branch a boolean IR picks
#   ("lut", col, aix, dtype)  arrays[aix][gid]: a value computed on the
#                             host over a string column's vocabulary
# Boolean nodes (residual conditions):
#   ("cmp", op, l, r)  ("inints", col, values, dtype)
#   ("incodes", col, gids)   string column membership by vocabulary id
#   ("band"/"bor", l, r)  ("bnot", x)  ("unknown",)   a NULL literal's
#                                                     comparison
# A planned program reads its constants from the card (`bind_consts`):
#   ("const", aix, dtype)         arrays[aix], a 0-dim view, for a "lit"
#   ("inconst", col, aix, dtype)  membership in arrays[aix], for "inints"
#                                 and a non-empty "incodes"
# so enqueuing a cached plan copies nothing to the card.  Other callers
# (the mesh) evaluate "lit" and the IN lists, uploaded at each use.

_INT_CASTS = ("int", "integer", "bigint", "smallint")


def _one_dict_column(e: ast.Expr, col_kinds) -> Optional[str]:
    """The single string (dictionary) column `e` reads, or None."""
    from liquid_tpu_torch.sql.physical import collect_columns
    cols: set = set()
    collect_columns(e, cols)
    if len(cols) != 1:
        return None
    c = next(iter(cols))
    return c if col_kinds.get(c) == "dict" else None


def _compile_expr(e: ast.Expr, col_kinds, dictres=None) -> Tuple[tuple, set]:
    """-> (ir, cols_used).  Raises _Bail on unsupported shapes.
    `dictres(col, op, literal)` resolves a string comparison on a
    dictionary column to the matching vocabulary ids."""
    if isinstance(e, ast.Column):
        k = col_kinds.get(e.name)
        if k == "planes":
            return ("col", e.name, "i64"), {e.name}
        if k == "float":
            return ("col", e.name, "f64"), {e.name}
        raise _Bail(f"column kind {k} in expression")
    if isinstance(e, ast.Literal):
        v = e.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise _Bail(f"literal {v!r}")
        return ("lit", v, "f64" if isinstance(v, float) else "i64"), set()
    if isinstance(e, ast.Unary) and e.op == "neg":
        x, cols = _compile_expr(e.operand, col_kinds, dictres)
        return ("neg", _ir_dtype(x), x), cols
    if isinstance(e, ast.Cast) and e.type_name in (
            "double", "float", "real", "decimal", "numeric"):
        x, cols = _compile_expr(e.operand, col_kinds, dictres)
        return _as_f64(x), cols
    if isinstance(e, ast.Cast) and e.type_name in _INT_CASTS:
        # ::INT over an integer image is a passthrough; float->int bails
        x, cols = _compile_expr(e.operand, col_kinds, dictres)
        if _ir_dtype(x) == "i64":
            return x, cols
        raise _Bail("float->int cast")
    if isinstance(e, ast.Cast) and e.type_name == "date":
        # a passthrough only over day counts or plain integers
        root = e.operand
        while isinstance(root, ast.Cast) and root.type_name in _INT_CASTS:
            root = root.operand
        if not isinstance(root, ast.Column):
            raise _Bail("::date over non-column")
        x, cols = _compile_expr(e.operand, col_kinds, dictres)
        t = col_kinds.arrow_type(root.name)
        if _ir_dtype(x) == "i64" and t is not None and (
                pa.types.is_date32(t) or pa.types.is_integer(t)
                or pa.types.is_boolean(t)):
            return x, cols
        raise _Bail(f"::date over {t}")
    if isinstance(e, ast.Case) and dictres is not None:
        # CASE WHEN c THEN v ... ELSE x END -> nested ("where", ...) nodes
        if e.operand is not None:
            raise _Bail("CASE <operand> form")
        if e.else_ is None:
            raise _Bail("CASE without ELSE (NULL branch)")
        out, cols = _compile_expr(e.else_, col_kinds, dictres)
        for cond, val in reversed(e.whens):
            c_ir, cc = _compile_bool(cond, col_kinds, dictres)
            v_ir, vc = _compile_expr(val, col_kinds, dictres)
            if _ir_dtype(v_ir) != _ir_dtype(out):
                v_ir, out = _as_f64(v_ir), _as_f64(out)
            out = ("where", _ir_dtype(v_ir), c_ir, v_ir, out)
            cols |= cc | vc
        return out, cols
    if isinstance(e, ast.Binary) and e.op in ("+", "-", "*", "/"):
        l, lc = _compile_expr(e.left, col_kinds, dictres)
        r, rc = _compile_expr(e.right, col_kinds, dictres)
        ldt, rdt = _ir_dtype(l), _ir_dtype(r)
        if e.op == "/":
            if ldt == "i64" and rdt == "i64":
                raise _Bail("integer division")
            l, r, dt = _as_f64(l), _as_f64(r), "f64"
        elif ldt == "f64" or rdt == "f64":
            l, r, dt = _as_f64(l), _as_f64(r), "f64"
        else:
            dt = "i64"
        return ("bin", e.op, dt, l, r), lc | rc
    if isinstance(e, ast.Extract):
        img, unit, cols = _time_image_ir(e.operand, col_kinds, dictres)
        return _extract_ir(e.field.lower(), img, unit), cols
    if isinstance(e, ast.Func) and e.name == "to_timestamp_seconds":
        img, _unit, cols = _time_image_ir(e, col_kinds, dictres)
        return img, cols
    if isinstance(e, ast.Func) and e.name == "date_trunc" \
            and len(e.args) == 2 and isinstance(e.args[0], ast.Literal):
        img, unit, cols = _time_image_ir(e.args[1], col_kinds, dictres)
        u = str(e.args[0].value).lower()
        widths = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}
        if unit != "s" or u not in widths:
            raise _Bail(f"date_trunc {u} over {unit}")
        w = widths[u]
        if w == 1:
            return img, cols
        return _bin("*", _fdiv(img, w), _ilit(w)), cols
    lutres = getattr(col_kinds, "lutres", None)
    c = _one_dict_column(e, col_kinds) if lutres is not None else None
    if c is not None:
        # a numeric function of one string column (length(URL)),
        # evaluated once per vocabulary entry
        got = lutres(e, c)
        if got is not None:
            aix, vdt = got
            return ("lut", c, aix, vdt), {c}
    raise _Bail(f"expression {type(e).__name__}")


# -- temporal lowering ---------------------------------------------------------
#
# extract / date_trunc / to_timestamp_seconds lower to integer IR over the
# column's stored i64 image (date32 days, epoch seconds), so temporal group
# keys stay on the device.  "fdiv" and "mod" are FLOOR division and floor
# modulo, as the reference's `//` and `%` are: days before 1970 and negative
# epoch seconds land in the right day, minute and year.  Civil dates use
# Howard Hinnant's integer civil_from_days.

def _bin(op: str, l, r):
    return ("bin", op, "i64", l, r)


def _ilit(v: int):
    return ("lit", v, "i64")


def _fdiv(x, k: int):
    return _bin("fdiv", x, _ilit(k))


def _mod(x, k: int):
    return _bin("mod", x, _ilit(k))


def _time_image_ir(e: ast.Expr, col_kinds, dictres):
    """-> (i64 IR, unit "days" | "s", columns)."""
    atype = getattr(col_kinds, "arrow_type", None)
    if isinstance(e, ast.Func) and e.name == "to_timestamp_seconds" \
            and len(e.args) == 1:
        x, cols = _compile_expr(e.args[0], col_kinds, dictres)
        if _ir_dtype(x) != "i64":
            raise _Bail("to_timestamp_seconds over non-int")
        return x, "s", cols
    if isinstance(e, ast.Column) and atype is not None:
        t = atype(e.name)
        x, cols = _compile_expr(e, col_kinds, dictres)
        if t is not None and pa.types.is_date32(t):
            return x, "days", cols
        if t is not None and pa.types.is_timestamp(t):
            div = {"s": 1, "ms": 1000, "us": 1000000,
                   "ns": 1000000000}.get(t.unit)
            if div is None:
                raise _Bail(f"timestamp unit {t.unit}")
            return (x if div == 1 else _fdiv(x, div)), "s", cols
    if isinstance(e, ast.Cast) and e.type_name == "date":
        x, cols = _compile_expr(e, col_kinds, dictres)
        return x, "days", cols
    raise _Bail(f"temporal operand {type(e).__name__}")


def _civil_ir(days):
    """days since the epoch (i64 IR) -> (year, month, day) IRs, exact over
    the whole date32 domain."""
    z = _bin("+", days, _ilit(719468))
    era = _fdiv(z, 146097)
    doe = _bin("-", z, _bin("*", era, _ilit(146097)))
    yoe = _fdiv(_bin("-", _bin("+", _bin("-", doe, _fdiv(doe, 1460)),
                               _fdiv(doe, 36524)), _fdiv(doe, 146096)), 365)
    y0 = _bin("+", yoe, _bin("*", era, _ilit(400)))
    doy = _bin("-", doe, _bin("-", _bin("+", _bin("*", _ilit(365), yoe),
                                        _fdiv(yoe, 4)), _fdiv(yoe, 100)))
    mp = _fdiv(_bin("+", _bin("*", _ilit(5), doy), _ilit(2)), 153)
    d = _bin("+", _bin("-", doy, _fdiv(_bin("+", _bin("*", _ilit(153), mp),
                                            _ilit(2)), 5)), _ilit(1))
    m = ("where", "i64", ("cmp", "<", mp, _ilit(10)),
         _bin("+", mp, _ilit(3)), _bin("-", mp, _ilit(9)))
    y = ("where", "i64", ("cmp", "<=", m, _ilit(2)), _bin("+", y0, _ilit(1)),
         y0)
    return y, m, d


def _extract_ir(field: str, img, unit: str):
    if field in ("minute", "hour", "second"):
        if unit != "s":
            raise _Bail(f"extract {field} from {unit}")
        if field == "second":
            return _mod(img, 60)
        if field == "minute":
            return _mod(_fdiv(img, 60), 60)
        return _mod(_fdiv(img, 3600), 24)
    days = img if unit == "days" else _fdiv(img, 86400)
    if field in ("year", "month", "day", "quarter"):
        y, m, d = _civil_ir(days)
        if field == "quarter":
            return _fdiv(_bin("+", m, _ilit(2)), 3)
        return {"year": y, "month": m, "day": d}[field]
    if field == "dow":
        # Sunday = 0; epoch day 0 was a Thursday
        return _mod(_bin("+", days, _ilit(4)), 7)
    raise _Bail(f"extract {field}")


_BOOL_CMP = {"=": "==", "<>": "!=", "!=": "!=", "<": "<", "<=": "<=",
             ">": ">", ">=": ">="}
_FLIP = {"=": "=", "<>": "<>", "!=": "!=", "<": ">", "<=": ">=", ">": "<",
         ">=": "<="}


def _compile_bool(e: ast.Expr, col_kinds, dictres=None) -> Tuple[tuple, set]:
    """Boolean IR of a residual condition, evaluated in SQL's
    three-valued logic (`_bool3`); a WHERE keeps its TRUE rows
    (`_bool_nonnull`)."""
    if isinstance(e, ast.Binary) and e.op in ("and", "or"):
        l, lc = _compile_bool(e.left, col_kinds, dictres)
        r, rc = _compile_bool(e.right, col_kinds, dictres)
        return ("band" if e.op == "and" else "bor", l, r), lc | rc
    if isinstance(e, ast.Unary) and e.op == "not":
        x, cols = _compile_bool(e.operand, col_kinds, dictres)
        return ("bnot", x), cols
    if isinstance(e, ast.Between):
        ir, cols = _compile_bool(ast.Binary(
            "and", ast.Binary(">=", e.operand, e.low),
            ast.Binary("<=", e.operand, e.high)), col_kinds, dictres)
        return (("bnot", ir) if e.negated else ir), cols
    if isinstance(e, ast.InList):
        if not isinstance(e.operand, ast.Column):
            # substring(c, 1, 2) IN ('13', ...): the operand evaluated over
            # the string column's vocabulary -> id membership
            vocab_eval = getattr(col_kinds, "vocab_eval", None)
            cn = _one_dict_column(e.operand, col_kinds)
            if vocab_eval is None or cn is None or any(
                    not isinstance(it, ast.Literal) for it in e.items):
                raise _Bail("IN over non-column")
            vals = vocab_eval(e.operand, cn)
            if vals is None:
                raise _Bail("IN over non-column")
            want = {it.value for it in e.items}
            ir = ("incodes", cn, tuple(i for i, v in enumerate(vals)
                                       if v is not None and v in want))
            return (("bnot", ir) if e.negated else ir), {cn}
        name = e.operand.name
        if col_kinds.get(name) == "dict":
            gids: set = set()
            has_null = False
            for it in e.items:
                if isinstance(it, ast.Literal) and it.value is None:
                    has_null = True
                    continue
                got = (dictres(name, "=", it.value)
                       if dictres is not None and isinstance(it, ast.Literal)
                       else None)
                if got is None:
                    raise _Bail(f"IN over {name}")
                gids.update(got)
            ir = _or_unknown(("incodes", name, tuple(sorted(gids))), has_null)
            return (("bnot", ir) if e.negated else ir), {name}
        vals = []
        has_null = any_float = False
        for it in e.items:
            if isinstance(it, ast.Unary) and it.op == "neg" \
                    and isinstance(it.operand, ast.Literal) \
                    and isinstance(it.operand.value, (int, float)) \
                    and not isinstance(it.operand.value, bool):
                it = ast.Literal(-it.operand.value)
            if not isinstance(it, ast.Literal):
                raise _Bail("IN list item")
            v = it.value
            if v is None:
                has_null = True
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise _Bail(f"IN item {v!r}")
            any_float = any_float or isinstance(v, float)
            vals.append(v)
        if not vals:
            raise _Bail("empty IN list")
        kind = col_kinds.get(name)
        if kind not in ("planes", "float"):
            raise _Bail(f"IN over column kind {kind}")
        dt = "f64" if any_float or kind == "float" else "i64"
        ir = _or_unknown(("inints", name, tuple(vals), dt), has_null)
        return (("bnot", ir) if e.negated else ir), {name}
    if isinstance(e, ast.Binary) and e.op == "like":
        got = None
        if isinstance(e.left, ast.Column) and isinstance(e.right, ast.Literal) \
                and dictres is not None:
            got = dictres(e.left.name, "like", e.right.value)
        if got is None:
            raise _Bail("LIKE shape")
        return ("incodes", e.left.name, tuple(got)), {e.left.name}
    if isinstance(e, ast.Binary) and e.op in _BOOL_CMP:
        l, r, op = e.left, e.right, e.op
        if isinstance(r, ast.Column) and not isinstance(l, ast.Column):
            l, r, op = r, l, _FLIP[op]
        if isinstance(l, ast.Column) and isinstance(r, ast.Literal) \
                and col_kinds.get(l.name) == "dict":
            if op not in ("=", "<>", "!="):
                raise _Bail("string ordering comparison")
            if r.value is None:  # = NULL and <> NULL are never TRUE
                return ("unknown",), {l.name}
            got = dictres(l.name, "=", r.value) if dictres else None
            if got is None:
                raise _Bail(f"string comparison over {l.name}")
            ir = ("incodes", l.name, tuple(got))
            return (("bnot", ir) if op != "=" else ir), {l.name}
        li, lc = _compile_expr(l, col_kinds, dictres)
        ri, rc = _compile_expr(r, col_kinds, dictres)
        if _ir_dtype(li) != _ir_dtype(ri):
            li, ri = _as_f64(li), _as_f64(ri)
        return ("cmp", _BOOL_CMP[op], li, ri), lc | rc
    raise _Bail(f"condition {type(e).__name__}")


def _or_unknown(ir, has_null: bool):
    """`x IN (..., NULL)` is `x IN (...) OR UNKNOWN`: TRUE on a match, else
    UNKNOWN, so its NOT is never TRUE."""
    return ("bor", ir, ("unknown",)) if has_null else ir


def bool_ir_columns(ir) -> set:
    """Column names referenced by a boolean/value IR tree."""
    tag = ir[0]
    if tag in ("col", "inints", "incodes", "lut", "inconst"):
        return {ir[1]}
    if tag in ("lit", "const"):
        return set()
    out: set = set()
    for part in ir[1:]:
        if isinstance(part, tuple) and part and isinstance(part[0], str):
            out |= bool_ir_columns(part)
    return out


_CMP_FNS = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
            ">": torch.gt, ">=": torch.ge}


#: per device, the null flag of every constant: one shared 0-dim False, so
#: a constant costs no fill on each run and an OR with it no launch
_NO_NULLS: Dict[torch.device, torch.Tensor] = {}


def _no_nulls(device) -> torch.Tensor:
    f = _NO_NULLS.get(device)
    if f is None:
        f = _NO_NULLS[device] = torch.zeros((), dtype=torch.bool,
                                            device=device)
    return f


def _or_nulls(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a | b, with no launch where one side is a constant's flag."""
    if b is _NO_NULLS.get(b.device):
        return a
    if a is _NO_NULLS.get(a.device):
        return b
    return a | b


def _lit(env, v, dt: str) -> torch.Tensor:
    return to_device(torch.tensor(v, dtype=torch.float64 if dt == "f64"
                                  else torch.int64), env.device)


def eval_ir_nulls(ir, env) -> Tuple[torch.Tensor, torch.Tensor]:
    """Null-aware IR interpreter -> (value, isnull).  `env.decode(name,
    dtype)` gives decoded column values, `env.nulls(name)` a column's
    null mask; value nodes propagate nulls, a boolean node gives its
    TRUE rows and its UNKNOWN rows (`_bool3`)."""
    tag = ir[0]
    if tag == "col":
        return env.decode(ir[1], ir[2]), env.nulls(ir[1])
    if tag == "lut":
        return env.decode(ir[1], ("lut", ir[2], ir[3])), env.nulls(ir[1])
    if tag == "const":
        return env.arrays[ir[1]], _no_nulls(env.device)
    if tag == "lit":
        return _lit(env, ir[1], ir[2]), torch.zeros((), dtype=torch.bool,
                                                    device=env.device)
    if tag == "cast":
        v, n = eval_ir_nulls(ir[2], env)
        return v.to(torch.float64), n
    if tag == "neg":
        v, n = eval_ir_nulls(ir[2], env)
        return -v, n
    if tag == "where":
        # the CHOSEN branch's null flag: sum(CASE WHEN k = 'A' THEN x ELSE
        # 0 END) counts a NULL-k row as 0
        _, _, c, t, f = ir
        cv = _bool_nonnull(c, env)
        tv, tn = eval_ir_nulls(t, env)
        fv, fn = eval_ir_nulls(f, env)
        return torch.where(cv, tv, fv), torch.where(cv, tn, fn)
    if tag in _BOOL_TAGS:
        return _bool3(ir, env)
    _, op, _, l, r = ir
    lv, ln = eval_ir_nulls(l, env)
    rv, rn = eval_ir_nulls(r, env)
    n = _or_nulls(ln, rn)
    if op == "+":
        return lv + rv, n
    if op == "-":
        return lv - rv, n
    if op == "*":
        return lv * rv, n
    if op == "fdiv":  # floor division, never truncation
        return torch.div(lv, rv, rounding_mode="floor"), n
    if op == "mod":  # floor modulo: the divisor's sign
        return torch.remainder(lv, rv), n
    return lv / rv, n


_BOOL_TAGS = ("cmp", "inints", "incodes", "inconst", "band", "bor", "bnot",
              "unknown")


def _bool3(ir, env) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean IR in SQL's three-valued logic -> (TRUE, UNKNOWN), two
    disjoint masks; FALSE is neither.  A NULL input makes a comparison or
    a membership UNKNOWN; AND is FALSE if either side is, OR is TRUE if
    either side is, NOT keeps UNKNOWN."""
    tag = ir[0]
    if tag == "cmp":
        _, op, l, r = ir
        lv, ln = eval_ir_nulls(l, env)
        rv, rn = eval_ir_nulls(r, env)
        unk = _or_nulls(ln, rn)
        return _CMP_FNS[op](lv, rv) & ~unk, unk
    if tag == "inconst":
        v = env.decode(ir[1], ir[3])
        want = env.arrays[ir[2]]  # the decode's dtype: int64 or float64
        unk = env.nulls(ir[1])
        return torch.isin(v, want) & ~unk, unk
    if tag == "inints":
        v = env.decode(ir[1], ir[3])
        want = to_device(torch.tensor(ir[2], dtype=v.dtype), env.device)
        unk = env.nulls(ir[1])
        return torch.isin(v, want) & ~unk, unk
    if tag == "incodes":
        gids = env.decode(ir[1], "i64")
        unk = env.nulls(ir[1])
        if not ir[2]:
            return torch.zeros_like(gids, dtype=torch.bool), unk
        want = to_device(torch.tensor(ir[2], dtype=torch.int64),
                         env.device)
        return torch.isin(gids, want) & ~unk, unk
    if tag == "unknown":
        return (torch.zeros((), dtype=torch.bool, device=env.device),
                torch.ones((), dtype=torch.bool, device=env.device))
    if tag == "bnot":
        t, u = _bool3(ir[1], env)
        return ~t & ~u, u
    t1, u1 = _bool3(ir[1], env)
    t2, u2 = _bool3(ir[2], env)
    if tag == "band":
        t = t1 & t2
        false = (~t1 & ~u1) | (~t2 & ~u2)
    elif tag == "bor":
        t = t1 | t2
        false = ~t1 & ~u1 & ~t2 & ~u2
    else:
        raise AssertionError(f"not a bool IR: {tag}")
    return t, ~t & ~false


def _bool_nonnull(ir, env) -> torch.Tensor:
    """Boolean IR's TRUE rows (a WHERE drops FALSE and UNKNOWN alike)."""
    return _bool3(ir, env)[0]


def _ir_dtype(ir) -> str:
    if ir[0] in ("col", "lit", "bin", "const"):
        return ir[2]
    if ir[0] == "lut":
        return ir[3]
    return ir[1]  # neg / cast


def _as_f64(ir):
    return ir if _ir_dtype(ir) == "f64" else ("cast", "f64", ir)


# -- scaled-integer rewrite of f64 sum inputs -----------------------------------
#
# An ALP column stores enc = round(v * 10^e): its f64 value IS a scaled
# integer.  A sum/avg/min/max input built from such columns, exact decimal
# literals and + - * rewrites to an EXACT i64 expression with a known
# decimal scale, divided by 10^scale only at host decode.  TPC-H q6's
# sum(l_extendedprice * l_discount) becomes a 10^-4-scaled i64 sum.

_SCALE_MAX = 14


def _lit_scaled(v):
    """Exact decimal (int, scale) of a numeric literal from its shortest
    repr (0.05 is decimal 5e-2, not its f64 approximation), or None."""
    from decimal import Decimal
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return (v, 0)
    if v != v or v in (float("inf"), float("-inf")):
        return None
    d = Decimal(repr(float(v)))
    exp = d.as_tuple().exponent
    if exp >= 0:
        return (int(d), 0)
    s = -exp
    if s > 6:
        return None
    return (int(d.scaleb(s)), s)


def _scale_up_ir(x, digits: int):
    return ("bin", "*", "i64", x, ("lit", 10 ** digits, "i64"))


def _scaled_int_ir(ir, scaledres, bounds_of):
    """f64 IR -> (int_ir, scale, maxabs) with value * 10^scale == int_ir
    exactly, or None when not provably a bounded scaled integer."""
    tag = ir[0]
    if tag == "col":
        if ir[2] == "i64":
            b = bounds_of(ir[1])
            if b is None:
                return None
            return (ir, 0, max(abs(b[0]), abs(b[1]), 1))
        info = scaledres(ir[1])
        if info is None:
            return None
        sc, ma = info
        return (("col", ir[1], "i64s"), sc, ma)
    if tag == "lit":
        got = _lit_scaled(ir[1])
        if got is None:
            return None
        iv, sc = got
        return (("lit", iv, "i64"), sc, max(abs(iv), 1))
    if tag == "cast":  # numeric identity
        return _scaled_int_ir(ir[2], scaledres, bounds_of)
    if tag == "neg":
        r = _scaled_int_ir(ir[2], scaledres, bounds_of)
        if r is None:
            return None
        x, sc, ma = r
        return (("neg", "i64", x), sc, ma)
    if tag == "bin" and ir[1] in ("+", "-", "*"):
        li = _scaled_int_ir(ir[3], scaledres, bounds_of)
        ri = _scaled_int_ir(ir[4], scaledres, bounds_of)
        if li is None or ri is None:
            return None
        lx, ls, lm = li
        rx, rs, rm = ri
        if ir[1] == "*":
            sc, ma = ls + rs, lm * rm
            x = ("bin", "*", "i64", lx, rx)
        else:
            sc = max(ls, rs)
            if ls < sc:
                lx, lm = _scale_up_ir(lx, sc - ls), lm * 10 ** (sc - ls)
            if rs < sc:
                rx, rm = _scale_up_ir(rx, sc - rs), rm * 10 ** (sc - rs)
            ma = lm + rm
            x = ("bin", ir[1], "i64", lx, rx)
        if sc > _SCALE_MAX or ma >= (1 << 62):
            return None
        return (x, sc, ma)
    return None


def _unscale_np(acc: np.ndarray, scale: int) -> np.ndarray:
    """f64 of acc / 10^scale: exact conversion and one correctly rounded
    division below 2^53; beyond, split off the integer part."""
    s10 = 10 ** scale
    acc = np.asarray(acc, np.int64)
    small = np.abs(acc) < (1 << 53)
    direct = acc.astype(np.float64) / float(s10)
    if small.all():
        return direct
    q, r = np.divmod(acc, s10)
    wide = q.astype(np.float64) + r.astype(np.float64) / float(s10)
    return np.where(small, direct, wide)


# -- per-column device prep -----------------------------------------------------

class _ColPrep:
    """Stacked device form of ONE column over the selected blocks, built
    once and cached (query-shape independent)."""

    __slots__ = ("kind", "arrow_type", "payloads", "planes_stack", "refs",
                 "inv", "valid_stack", "lin_stack", "patch_rows",
                 "patch_vals", "codes_stack", "dmax", "vocab_list",
                 "remap_stack", "gid_stack")

    def __init__(self):
        self.planes_stack = self.refs = self.inv = self.lin_stack = None
        self.patch_rows = self.patch_vals = self.codes_stack = None
        self.vocab_list = self.remap_stack = self.gid_stack = None


def _stack_planes(payloads, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block planes zero-padded to the widest bucket (zero planes are
    transparent), assembled on the host and uploaded once."""
    wb = max(max(p.planes_np.shape[0] for p in payloads), 1)
    out = np.zeros((len(payloads), wb, _W), np.uint32)
    for i, p in enumerate(payloads):
        pl = p.planes_np
        if pl.shape[0]:
            out[i, : pl.shape[0]] = pl
    refs = np.array([wrap_i64(p.reference_value) for p in payloads],
                    np.int64)
    return words_to_tensor(out, device), torch.from_numpy(refs).to(device)


_FULL_WORDS = np.full(_W, 0xFFFFFFFF, np.uint32)


def _stack_validity(payloads, device) -> Optional[torch.Tensor]:
    if all(p.validity_np is None for p in payloads):
        return None
    out = np.empty((len(payloads), _W), np.uint32)
    for i, p in enumerate(payloads):
        v = p.validity_np
        out[i] = v if v is not None else _FULL_WORDS
    return words_to_tensor(out, device)


def _prep_column(payloads, arrow_type, device) -> _ColPrep:
    prep = _ColPrep()
    prep.arrow_type = arrow_type
    prep.payloads = list(payloads)
    p0 = payloads[0]
    if pa.types.is_decimal(arrow_type):
        # unscaled integers: raw-literal intervals and i64 sums would be
        # wrong, so a decimal query takes the classic path (the star and
        # select routes reach here without `_schema_kind`)
        raise _Bail("decimal column")
    if isinstance(p0, (LiquidLinearArray, LiquidPrimitiveArray)) and any(
            isinstance(p, LiquidLinearArray) for p in payloads):
        # the transcoder picks linear per block, so a column mixes both;
        # a plain block is a linear block with slope 0
        if any(not isinstance(p, (LiquidLinearArray, LiquidPrimitiveArray))
               for p in payloads):
            raise _Bail("mixed payload classes")
        prep.kind = "linear"
        res = [p.residuals if isinstance(p, LiquidLinearArray) else p
               for p in payloads]
        prep.planes_stack, prep.refs = _stack_planes(res, device)
        prep.valid_stack = _stack_validity(res, device)
        # round(slope*i) on the HOST with the encoder's numpy rounding
        lin = np.stack([linear_term(p.slope)
                        if isinstance(p, LiquidLinearArray)
                        else np.zeros(BLOCK_ROWS, np.int64)
                        for p in payloads])
        if np.abs(lin).max(initial=0) < (1 << 31):
            lin = lin.astype(np.int32)
        prep.lin_stack = torch.from_numpy(lin).to(device)
        return prep
    if isinstance(p0, LiquidPrimitiveArray):
        if any(not isinstance(p, LiquidPrimitiveArray) for p in payloads):
            raise _Bail("mixed payload classes")
        prep.kind = "planes"
    elif isinstance(p0, LiquidFloatArray):
        if any(not isinstance(p, LiquidFloatArray) for p in payloads):
            raise _Bail("mixed payload classes")
        prep.kind = "float"
        prep.inv = torch.tensor([p.inv for p in payloads],
                                dtype=torch.float64, device=device)
        rows = [p.patch_idx.astype(np.int64) + b * BLOCK_ROWS
                for b, p in enumerate(payloads) if p.num_patches]
        if rows:
            prep.patch_rows = np.concatenate(rows)
            prep.patch_vals = np.concatenate(
                [p.patch_vals for p in payloads if p.num_patches])
    elif isinstance(p0, LiquidByteViewArray):
        if any(not isinstance(p, LiquidByteViewArray) for p in payloads):
            raise _Bail("mixed payload classes")
        prep.kind = "dict"
        prep.codes_stack = torch.from_numpy(
            np.stack([p.codes_np for p in payloads])).to(device)
        prep.valid_stack = _stack_validity(payloads, device)
        prep.dmax = max(max(p.dict_size for p in payloads), 1)
        return prep
    else:
        raise _Bail(f"payload {type(p0).__name__}")
    prep.planes_stack, prep.refs = _stack_planes(payloads, device)
    prep.valid_stack = _stack_validity(payloads, device)
    return prep


def _build_vocab(prep: _ColPrep) -> None:
    """The column's global vocabulary and per-block remap, built once
    when the column is a key or in expression IR.  The vocabulary is
    SORTED (str order is code-point order, which UTF-8 byte order keeps),
    with NULL last, so id order is value order: min/max over ids decode
    to the min/max string."""
    if prep.vocab_list is not None:
        return
    per_block = [p.dictionary.to_pylist() for p in prep.payloads]
    values = set()
    for vals in per_block:
        values.update(vals)
    vocab_list = sorted(v for v in values if v is not None)
    if None in values:
        vocab_list.append(None)
    vocab = {v: i for i, v in enumerate(vocab_list)}
    remaps = np.zeros((len(prep.payloads), prep.dmax), np.int64)
    for b, vals in enumerate(per_block):
        remaps[b, : len(vals)] = [vocab[v] for v in vals]
    prep.vocab_list = vocab_list
    prep.remap_stack = torch.from_numpy(remaps).to(prep.codes_stack.device)


def _gid_stack(prep: _ColPrep) -> torch.Tensor:
    """int32 [nb, 8192] global vocabulary ids: the remap gathered on the
    device once per column and cached, so no query pays the per-row
    gather (it depends on the stored data only)."""
    if prep.gid_stack is None:
        remap = prep.remap_stack
        codes = prep.codes_stack.clamp(0, remap.shape[1] - 1)
        prep.gid_stack = torch.gather(remap, 1, codes.to(torch.int64)
                                      ).to(torch.int32)
    return prep.gid_stack


def vocab_eval_expr(e: ast.Expr, col: str, vocab: list) -> Optional[list]:
    """Evaluate a one-column string expression over the column's
    vocabulary with the host evaluator (distinct values only, once per
    plan) -> one Python value per vocabulary id, or None when the
    evaluator cannot run it."""
    from liquid_tpu_torch.sql.eval import Batch, Evaluator
    try:
        out = Evaluator(Batch({col: pa.array(vocab, pa.string())},
                              len(vocab))).arr(e)
    except (NotImplementedError, KeyError, TypeError, ValueError,
            pa.ArrowException):
        return None
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    return out.to_pylist()


def _string_key_lut(ge: ast.Expr, kinds_view, p: "_Plan", dev):
    """A string-valued group key over ONE string column -> (IR ("lut",
    col, aix, "i64") of ids in the mapped vocabulary, columns, the mapped
    vocabulary), or None when not applicable."""
    c = _one_dict_column(ge, kinds_view)
    if c is None:
        return None
    vals = kinds_view.vocab_eval(ge, c)
    if vals is None or not all(v is None or isinstance(v, str)
                               for v in vals):
        return None
    uniq = sorted({v for v in vals if v is not None})
    idx = {v: i for i, v in enumerate(uniq)}
    if any(v is None for v in vals):
        uniq.append(None)  # keyed by the trailing NULL id
    lut = np.array([idx.get(v, len(idx)) for v in vals], np.int64)
    aix = _add(p, to_device(torch.from_numpy(lut), dev))
    return ("lut", c, aix, "i64"), {c}, uniq


def _like_regex(pat: str):
    """SQL LIKE pattern -> an anchored regular expression."""
    return re.compile(
        "^" + re.escape(pat).replace("%", ".*").replace("_", ".") + "$",
        re.DOTALL)


def _dict_lut(payloads, pred: Predicate, dmax: int) -> Optional[np.ndarray]:
    """bool [nb, dmax]: each block's verdict per dictionary entry (prefix
    keys / fingerprints / pyarrow kernels, cached per block), or None
    when the predicate has no verdict form."""
    luts = np.zeros((len(payloads), dmax), bool)
    for b, pp in enumerate(payloads):
        vd = pp.dict_verdict(pred)
        if vd is None:
            return None
        luts[b, : len(vd)] = vd
    return luts


# -- predicate lowering ----------------------------------------------------------

def _primitive_interval(payloads, pred: Predicate):
    """-> (lo u64[nb], hi u64[nb] inclusive, negate) or None."""
    if isinstance(pred.literal, bool) and pa.types.is_boolean(
            payloads[0].arrow_type):
        # bool blocks store 0/1 in the packed domain
        pred = Predicate(pred.op, int(pred.literal))
    negate = pred.op == "ne"  # the only complemented interval form
    lo = np.zeros(len(payloads), np.uint64)
    hi = np.zeros(len(payloads), np.uint64)
    full = (np.uint64(0), np.uint64(_U64MAX))
    empty = (np.uint64(1), np.uint64(0))
    for b, p in enumerate(payloads):
        if p.planes_np.shape[0] >= 64:
            return None  # interval form needs hi < 2^64-1
        plan = p.packed_plan(pred)
        if plan is None:
            return None
        if plan[0] == "const":
            # mask = negate XOR (off in [lo, hi])
            lo[b], hi[b] = full if bool(plan[1]) != negate else empty
            continue
        _, u, op = plan
        if (op == "ne") != negate:
            return None
        u = int(u)
        if op in ("eq", "ne"):
            lo[b], hi[b] = u, u
        elif op == "lt":
            lo[b], hi[b] = 0, u - 1  # u >= 1 (in-domain)
        elif op == "lt_eq":
            lo[b], hi[b] = 0, u
        elif op == "gt":
            lo[b], hi[b] = u + 1, _U64MAX
        else:  # gt_eq
            lo[b], hi[b] = u, _U64MAX
    return lo, hi, negate


_NP_CMP = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
           "lt_eq": np.less_equal, "gt": np.greater, "gt_eq": np.greater_equal}


def _float_interval(payloads, pred: Predicate):
    """ALP predicate as per-block offset intervals (the decode map is
    monotone); exception-patch rows are settled on the host into packed
    (clear, set) word overlays.
    -> (lo, hi, negate, clear_words|None, set_words|None) or None."""
    import math
    if pred.op not in _NP_CMP:
        return None
    lit = pred.literal
    if isinstance(lit, bool) or not isinstance(
            lit, (int, float, np.integer, np.floating)):
        return None
    lit = float(lit)
    lo = np.zeros(len(payloads), np.uint64)
    hi = np.zeros(len(payloads), np.uint64)
    clear = setw = None
    for b, p in enumerate(payloads):
        if p.num_patches:
            if clear is None:
                clear = np.full((len(payloads), _W), 0xFFFFFFFF, np.uint32)
                setw = np.zeros((len(payloads), _W), np.uint32)
            pv = p.patch_vals
            if pa.types.is_float32(p.arrow_type):
                pv = pv.astype(np.float32).astype(np.float64)
            verdict = _NP_CMP[pred.op](pv, np.float64(lit))
            words = p.patch_idx // 32
            bits = np.uint32(1) << (p.patch_idx % 32).astype(np.uint32)
            np.bitwise_and.at(clear[b], words, ~bits)
            np.bitwise_or.at(setw[b], words,
                             np.where(verdict, bits, np.uint32(0)))
        if p.planes_np.shape[0] >= 64:
            return None
        if math.isnan(lit):
            lo[b], hi[b] = np.uint64(1), np.uint64(0)  # ne negates to all
            continue
        t_ge = p.lower_bound(lit, strict=False)
        t_gt = p.lower_bound(lit, strict=True)
        if pred.op == "lt":
            l, h = (0, t_ge - 1) if t_ge > 0 else (1, 0)
        elif pred.op == "lt_eq":
            l, h = (0, t_gt - 1) if t_gt > 0 else (1, 0)
        elif pred.op == "gt":
            l, h = t_gt, _U64MAX
        elif pred.op == "gt_eq":
            l, h = t_ge, _U64MAX
        else:  # eq / ne
            l, h = (t_ge, t_gt - 1) if t_gt > t_ge else (1, 0)
        lo[b], hi[b] = l, h
    return lo, hi, pred.op == "ne", clear, setw


# -- the device program ------------------------------------------------------------

def _in_interval_many(planes_stack: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """Packed masks off in [lo, hi] (inclusive, per-block u64 bounds as
    int64 images): one launch of K1's interval form on the card."""
    return bitpack_cuda.in_interval_many(planes_stack, lo, hi)


def _selection_packed(colmap, pred_groups, arrays, sel: torch.Tensor
                      ) -> torch.Tensor:
    """AND every pushdown group's packed per-block mask into `sel`
    (int32 [nb, 256]); the alternatives of a group are OR-ed."""
    for grp in pred_groups:
        gm = None
        for alt in grp:
            cix = colmap[alt[1]]
            if alt[0] == "lut":  # per-block verdicts over dictionary codes
                lut = arrays[alt[2]]
                codes = arrays[cix["codes"]].clamp(0, lut.shape[1] - 1)
                m = mops.pack_bools(torch.gather(lut, 1,
                                                 codes.to(torch.int64)))
            else:
                m = _in_interval_many(arrays[cix["planes"]], arrays[alt[2]],
                                      arrays[alt[3]])
                if alt[4]:
                    m = ~m
                if alt[0] == "ivp":  # ALP exception-patch overlay
                    m = (m & arrays[alt[5]]) | arrays[alt[6]]
            if "valid" in cix:
                m = m & arrays[cix["valid"]]
            gm = m if gm is None else (gm | m)
        sel = sel & gm
    return sel


class _Decoders:
    """Decoded column values and null masks for one program run, each
    computed once.  `probe_j` maps a probe id to its per-row dimension
    row (int32, -1 = no match); a "pay" column (a dimension's decoded
    payload) is gathered through it, and a row without a match reads as
    NULL."""

    def __init__(self, colmap, arrays, n: int, device, probe_j=None):
        self.colmap, self.arrays, self.n, self.device = (colmap, arrays, n,
                                                         device)
        self.probe_j: Dict[int, torch.Tensor] = ({} if probe_j is None
                                                 else probe_j)
        self._vals: Dict[Tuple[str, str], torch.Tensor] = {}
        self._nulls: Dict[str, torch.Tensor] = {}

    def _pay_rows(self, cix, table: torch.Tensor) -> torch.Tensor:
        # a torch gather at -1 would read the last entry: clamp, and let
        # the miss flag carry the -1
        return table[self.probe_j[cix["probe"]].clamp(0, table.shape[0] - 1)]

    def nulls(self, name: str) -> torch.Tensor:
        out = self._nulls.get(name)
        if out is None:
            cix = self.colmap[name]
            if cix["kind"] == "pay":
                out = self.probe_j[cix["probe"]] < 0
                if "nulls" in cix:
                    out = out | self._pay_rows(cix, self.arrays[cix["nulls"]])
            elif "valid" in cix:
                out = ~mops.unpack_bits(self.arrays[cix["valid"]]).reshape(-1)
            else:
                out = torch.zeros(self.n, dtype=torch.bool, device=self.device)
            self._nulls[name] = out
        return out

    def decode(self, name: str, dt) -> torch.Tensor:
        out = self._vals.get((name, dt))
        if out is not None:
            return out
        a = self.arrays
        cix = self.colmap[name]
        if isinstance(dt, tuple):  # ("lut", aix, dtype): table[gid]
            table = a[dt[1]]
            v = table[self.decode(name, "i64").clamp(0, table.shape[0] - 1)]
            if dt[2] == "f64":
                v = v.to(torch.float64)
            self._vals[(name, dt)] = v
            return v
        if cix["kind"] == "pay":
            v = self._pay_rows(cix, a[cix["vals"]])
            if dt == "f64":
                v = v.to(torch.float64)
            self._vals[(name, dt)] = v
            return v
        if cix["kind"] == "dict":
            # global vocabulary ids where the plan registered them, raw
            # per-block codes otherwise (only their nullness is read)
            v = a[cix["gids" if "gids" in cix else "codes"]].reshape(-1)
            v = v.to(torch.int64)
            self._vals[(name, dt)] = v
            return v
        off = bp.unpack_bitplanes_many(a[cix["planes"]])
        enc = off + a[cix["refs"]][:, None]
        if cix["kind"] == "float":
            if dt == "i64s":
                # exact scaled-int image enc * 10^(E - e_block), with the
                # validated scaled images of the exception patches
                v = (enc * a[cix["smult"]][:, None]).reshape(-1)
                if "spatch" in cix:
                    v[a[cix["patch_rows"]]] = a[cix["spatch"]]
            else:
                v = (enc.to(torch.float64) * a[cix["inv"]][:, None]
                     ).reshape(-1)
                if "patch_rows" in cix:
                    v[a[cix["patch_rows"]]] = a[cix["patch_vals"]]
        else:
            if cix["kind"] == "linear":  # host-exact round(slope * i)
                enc = enc + a[cix["lin"]].to(torch.int64)
            v = enc.reshape(-1)
            if dt == "f64":
                v = v.to(torch.float64)
        self._vals[(name, dt)] = v
        return v


def probe_dims(probes, arrays, env: _Decoders, selb: torch.Tensor
               ) -> torch.Tensor:
    """Star-join probes, shared by the fact program and the snowflake
    dimension builds: each scanned row's dimension row j (int32, -1 where
    a key is NULL, outside the table or absent) goes into `env.probe_j`;
    an INNER join drops the rows that miss.  Two forms:

    (pid, key column, idx, lo) -- a unique single-column key:
        j = idx[key - lo].
    (pid, key column, idx, lo, key2 column, ord, cnt, vals2, max_dup) --
        a composite two-column key (the sorted chain index, TPC-H q9's
        partsupp): the dimension rows sorted by (key, key2); idx[key - lo]
        is the first sorted position of key and cnt its run length; the
        probe tries max_dup positions against key2 and maps the hit to
        the dimension row through ord."""
    none = torch.full((), -1, dtype=torch.int32, device=selb.device)
    for pr in probes:
        pid, kname, idx_ix, lo_ix = pr[:4]
        kv = env.decode(kname, "i64")
        tbl = arrays[idx_ix]
        rel = kv - arrays[lo_ix]
        inb = (rel >= 0) & (rel < tbl.shape[0]) & ~env.nulls(kname)
        # negative indices wrap in torch: clamp before every gather
        relc = rel.clamp(0, tbl.shape[0] - 1)
        if len(pr) == 4:
            j = torch.where(inb, tbl[relc], none)
        else:
            k2name, ord_ix, cnt_ix, vals2_ix, max_dup = pr[4:]
            k2 = env.decode(k2name, "i64")
            inb = inb & ~env.nulls(k2name)
            ordv, vals2 = arrays[ord_ix], arrays[vals2_ix]
            j0, c = tbl[relc], arrays[cnt_ix][relc]
            pos = torch.full_like(j0, -1)
            for d in range(max_dup):
                cand = (j0 + d).clamp(0, vals2.shape[0] - 1)
                hit = inb & (j0 >= 0) & (c > d) & (vals2[cand] == k2)
                pos = torch.where(hit, cand, pos)
            j = torch.where(pos >= 0, ordv[pos.clamp(0, ordv.shape[0] - 1)],
                            none)
        env.probe_j[pid] = j
        selb = selb & (j >= 0)
    return selb


def exist_probes(eprobes, arrays, env: _Decoders, selb: torch.Tensor
                 ) -> torch.Tensor:
    """EXISTS / NOT EXISTS / [NOT] IN <subquery> as existence probes:
    per row, hit = the inner relation has a row with this key
    (cnt[key - lo] > 0; a NULL key never hits).  With a disambiguator
    column c (TPC-H q21's `inner.c <> outer.c`) the hit needs an inner
    row whose c differs from ours: min != v or max != v, and a NULL v
    never hits.  Modes: semi keeps hits, anti drops them, anti_nn (NOT
    IN) also drops a NULL key.  `eprobes` holds (key column, cnt, lo,
    mode, min, max, mm column), min / max -1 without a disambiguator."""
    for kname, cnt_ix, lo_ix, mode, mn_ix, mx_ix, mmname in eprobes:
        kv = env.decode(kname, "i64")
        knl = env.nulls(kname)
        cnt = arrays[cnt_ix]
        rel = kv - arrays[lo_ix]
        inb = (rel >= 0) & (rel < cnt.shape[0]) & ~knl
        relc = rel.clamp(0, cnt.shape[0] - 1)
        hit = inb & (cnt[relc] > 0)
        if mn_ix >= 0:
            mv = env.decode(mmname, "i64")
            hit = hit & ((arrays[mn_ix][relc] != mv)
                         | (arrays[mx_ix][relc] != mv)) & ~env.nulls(mmname)
        if mode == "semi":
            selb = selb & hit
        elif mode == "anti":
            selb = selb & ~hit
        else:  # NOT IN: a NULL operand makes the predicate NULL
            selb = selb & ~hit & ~knl
    return selb


def _fd_keys(kv: torch.Tensor, knl: torch.Tensor, fd, arrays):
    """The full group-key rows (int64 code images) and null rows (bool)
    of a functional-dependency plan, from the representative key's rows
    `kv` / `knl`: every derived key gathers a dimension payload through
    j -- kv itself in probe-index mode (idx_ix < 0), idx[kv - lo] in value
    mode.  fd = (rep_pos, nk_full, entries), entries (out_pos, idx_ix,
    lo_ix, vals_ix, nulls_ix | -1, ptype)."""
    rep_pos, nk_full, entries = fd
    keys: List[Optional[torch.Tensor]] = [None] * nk_full
    nulls: List[Optional[torch.Tensor]] = [None] * nk_full
    keys[rep_pos], nulls[rep_pos] = kv, knl.to(torch.bool)
    for pos, idx_ix, lo_ix, vals_ix, nulls_ix, ptype in entries:
        if idx_ix < 0:  # probe-index mode: kv IS the dimension row id
            j = kv
        else:
            idxt = arrays[idx_ix]
            j = idxt[(kv - arrays[lo_ix]).clamp(0, idxt.shape[0] - 1)]
        vals = arrays[vals_ix]
        jc = j.clamp(0, vals.shape[0] - 1).to(torch.int64)
        v = vals[jc]
        keys[pos] = (floatbits.f64_bits(v + 0.0) if ptype == "f64"
                     else v.to(torch.int64))
        nl = j < 0
        if nulls_ix >= 0:
            nl = nl | arrays[nulls_ix][jc]
        nulls[pos] = nl
    return keys, nulls


def _apply_fd_packed(mat: torch.Tensor, fd, arrays) -> torch.Tensor:
    """A packed matrix [hdr, kv, knl, outs..., counts...] reduced on the
    representative key -> [hdr, keys..., key nulls..., outs..., counts...]
    with every group key: the derived keys gather at pack time (w rows),
    nothing per input row."""
    keys, nulls = _fd_keys(mat[1], mat[2], fd, arrays)
    return torch.stack([mat[0]] + keys + [n.to(torch.int64) for n in nulls]
                       + list(mat[3:]))


def _fused_core(p: "_Plan", grouped=None, tkspec=()):
    """Run the program.  Scalar (`grouped` None) -> int64[2 * n_slots]:
    per slot the reduced value (f64 as its bit image), then the per-slot
    counts.  Grouped -> the reduction's (mat, clean, n_groups, cols), with
    the top-k superset in place of cols when `tkspec` is set; under a
    functional-dependency plan the reduction runs on the physical key and
    mat and the top-k superset carry every group key.
    `grouped` is ("direct", spans, los, pallas_seg, having), ("hash",
    n_slots, salt, rounds) or ("sortpairs", recipes, kinds2, n_slots, salt,
    rounds): count(DISTINCT d) with d the last key, reduced on the other
    keys (`_first_pairs`)."""
    arrays = p.arrays
    sel = _selection_packed(p.colmap, p.pred_groups, arrays,
                            arrays[p.rv_ix])
    selb = mops.unpack_bits(sel).reshape(-1)
    env = _Decoders(p.colmap, arrays, selb.shape[0], selb.device)
    selb = probe_dims(p.probes, arrays, env, selb)
    selb = exist_probes(p.eprobes, arrays, env, selb)
    for ir in p.resids:
        selb = selb & _bool_nonnull(ir, env)

    # aggregate inputs, NULL-exact; count(col) counts rows whose columns
    # are non-null, count(expr) rows whose expression is non-null
    vals, vnulls, kinds = [], [], []
    for (kind, _dt, ir, nullcols) in p.rslots:
        if ir == ("ones",):
            v = torch.ones_like(selb, dtype=torch.int64)
            vn = torch.zeros_like(selb)
            for cn in nullcols:
                vn = vn | env.nulls(cn)
        elif ir[0] == "nncount":
            _v, vn = eval_ir_nulls(ir[1], env)
            v = torch.ones_like(selb, dtype=torch.int64)
        else:
            v, vn = eval_ir_nulls(ir, env)
        vals.append(v.expand(selb.shape))
        vnulls.append(vn.expand(selb.shape))
        kinds.append(kind)
    if grouped is None:
        outs, counts = scalar_reduce(selb, vals, vnulls, kinds)
        packed = [floatbits.f64_bits(o.reshape(1)) if o.dtype == torch.float64
                  else o.to(torch.int64).reshape(1) for o in outs]
        packed += [c.reshape(1) for c in counts]
        return torch.cat(packed)

    # grouped: key code images (f64 keys by their canonical bit image,
    # -0.0 folded into +0.0); a NULL key codes as 0 beside its flag
    codes, knulls = [], []
    for name in _red_keys(p):
        if isinstance(name, tuple) and name[0] == "probe":
            # probe-index grouping: the key is the dense dimension row j;
            # every key value re-attaches at pack time (_apply_fd_packed)
            code = env.probe_j[name[1]].to(torch.int64)
            nl = torch.zeros_like(selb)
        elif isinstance(name, tuple):  # ("expr", ir, dt)
            _, ir, dt = name
            v, nl = eval_ir_nulls(ir, env)
            v, nl = v.expand(selb.shape), nl.expand(selb.shape)
            code = (floatbits.f64_bits(v + 0.0) if dt == "f64"
                    else v.to(torch.int64))
        else:
            cix = p.colmap[name]
            if cix["kind"] == "float" or cix.get("ptype") == "f64":
                code = floatbits.f64_bits(env.decode(name, "f64") + 0.0)
            else:
                code = env.decode(name, "i64")
            nl = env.nulls(name)
        codes.append(torch.where(nl, torch.zeros_like(code), code))
        knulls.append(nl)
    if grouped[0] == "sortpairs":
        # one flag per distinct (keys, d): nunique is a per-key sum of
        # flags, and every other aggregate reduces over the raw rows
        _, recipes, kinds2, n_slots, salt, rounds = grouped
        flag = _first_pairs(selb, codes, knulls)
        vals2, vnulls2 = [], []
        for r in recipes:
            if r[0] == "nunique":
                vals2.append(flag.to(torch.int64))
                vnulls2.append(~flag)
            else:
                vals2.append(vals[r[1]])
                vnulls2.append(vnulls[r[1]])
        return hops.hash_rounds_reduce_packed(
            codes[:-1], knulls[:-1], selb, vals2, vnulls2, kinds2, n_slots,
            salt, rounds)
    if grouped[0] == "direct":
        _, spans, los, pseg, having = grouped
        res = hops.direct_reduce_packed(codes, knulls, selb, vals, vnulls,
                                        kinds, los, spans, pseg, having)
    else:
        _, n_slots, salt, rounds = grouped
        res = hops.hash_rounds_reduce_packed(codes, knulls, selb, vals,
                                             vnulls, kinds, n_slots, salt,
                                             rounds)
    if p.fd:
        mat, clean, ng, cols = res
        res = (_apply_fd_packed(mat, p.fd, arrays), clean, ng, cols)
    if tkspec:
        # top-k inside the program: only the k2 gathered rows are fetched
        mat, clean, ng, cols = res
        mini = _topk_gather_core(cols, tkspec, len(codes), len(p.rslots))
        if p.fd:  # [head, rank, kv, knl, ...]: the rank rides as the header
            mini = torch.cat([mini[:1], _apply_fd_packed(mini[1:], p.fd,
                                                         arrays)])
        return (mat, clean, ng, mini)
    return res


def _first_pairs(selb: torch.Tensor, codes, knulls) -> torch.Tensor:
    """bool [n]: True at exactly one selected row of each distinct key
    tuple whose last key (the DISTINCT column d) is not NULL.  The
    reference's multi-key `jax.lax.sort` becomes stable `torch.sort`
    passes, last key first, carrying the permutation.  Only adjacency of
    equal tuples matters, so the row's deadness and every key's NULL flag
    ride as bits of one leading key."""
    n = selb.shape[0]
    dev = selb.device
    flags = (~selb).to(torch.int64)
    for i, nl in enumerate(knulls):
        flags = flags | (nl.to(torch.int64) << (i + 1))
    keys = [flags] + list(codes)
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    for k in reversed(keys):
        _, order = torch.sort(k[perm], stable=True)
        perm = perm[order]
    anyneq = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
    for k in keys:
        ks = k[perm]
        anyneq = anyneq | (ks[1:] != ks[:-1])
    new_s = torch.ones(n, dtype=torch.bool, device=dev)
    new_s[1:] = anyneq
    flags_s = flags[perm]
    # a dead row, or a NULL d (bit nk), never counts
    dead = (flags_s & (1 | (1 << len(codes)))) != 0
    flag = torch.zeros(n, dtype=torch.bool, device=dev)
    flag[perm] = new_s & ~dead  # perm is a permutation: a plain scatter
    return flag


# -- planning ----------------------------------------------------------------------

class _Plan:
    """Everything needed to run and decode one fused aggregate."""

    def __init__(self):
        self.arrays: List[torch.Tensor] = []
        self.colmap: Dict[str, dict] = {}
        self.pred_groups: List[tuple] = []
        self.resids: List[tuple] = []
        self.rslots: List[tuple] = []
        self.rv_ix = -1
        self.slot_map: List[tuple] = []   # per AggSlot: (kind, rslot indices)
        self.slot_types: Dict[str, pa.DataType] = {}
        self.keys: List[object] = []      # column names or ("expr", ir, dt)
        self.key_out: List[str] = []      # output column names
        #: per key: ("codec", KeyCodec) or ("vocab", values, arrow type),
        #: the latter for keys coded by vocabulary id
        self.key_decoders: List[tuple] = []
        self.key_payloads: Dict[str, list] = {}  # planes keys: span bound
        #: min/max over a string column: its sorted vocabulary
        self.slot_vocabs: Dict[str, list] = {}
        self.rslot_maxabs: List[Optional[int]] = []  # |value| bounds
        self.having = None                # (rslot, op, literal) on device
        #: star probes: (pid, fact key column, idx array, lo array), or
        #: the composite form of `probe_dims`
        self.probes: List[tuple] = []
        #: existence probes (`exist_probes`)
        self.eprobes: List[tuple] = []
        #: functional-dependency plan (rep_pos, nk_full, entries), or None
        self.fd = None
        #: the reduction's keys under `fd`: [rep column] or [("probe", pid)]
        self.phys_keys: List[object] = []
        #: star keys' (lo, hi) value bounds (dimension payloads, probe j)
        self.key_bounds: Dict[object, tuple] = {}
        #: the direct path's per-key lower bounds, an int64 array index
        #: (`bind_consts`), or None
        self.los_ix: Optional[int] = None
        #: constants awaiting their upload (`_const`, `place_consts`), per
        #: dtype: (array index, values or one value, is a list)
        self.pending: Dict[str, list] = {"i64": [], "f64": []}
        #: the reduction's keys as compiled, before `bind_consts`: a
        #: table's stage hints are keyed by them, so plans of one key
        #: expression share a hint whatever their array layouts
        self.stage_keys: Optional[tuple] = None


def _red_keys(p: _Plan) -> list:
    """The keys the reduction runs on: the physical key under FD."""
    return p.phys_keys if p.fd else p.keys


def _stage_keys(p: _Plan) -> tuple:
    """The reduction's keys as a stage hint keys them."""
    return p.stage_keys if p.stage_keys is not None else tuple(_red_keys(p))


def _add(plan: _Plan, arr: torch.Tensor) -> int:
    plan.arrays.append(arr)
    return len(plan.arrays) - 1


# -- a plan's constants on the card ---------------------------------------------
#
# Every literal, IN list and bound a planned program reads goes into one
# int64 and one float64 tensor per plan, uploaded once when it is planned;
# the IR reads 0-dim and 1-dim views of them.  A copy from pageable memory
# synchronizes the stream, so uploading at each use would drain the card
# once per literal while the host enqueues.  The views keep the dtypes the
# per-use uploads had: an i64 literal stays an int64 tensor (a Python
# float times it would promote to float32).

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _const(p: _Plan, v, dt: str) -> int:
    """Reserve the array index of constant `v` (a number, or a tuple for
    an IN list) of dtype `dt`; `place_consts` fills it."""
    ix = _add(p, None)
    p.pending[dt].append((ix, v, isinstance(v, tuple)))
    return ix


def _fits(v, dt: str) -> bool:
    """An int64 constant in range (a wider one keeps its per-use upload,
    which raises as before)."""
    vals = v if isinstance(v, tuple) else (v,)
    return dt == "f64" or all(_I64_MIN <= x <= _I64_MAX for x in vals)


def bind_ir(p: _Plan, ir):
    """IR with its literals and IN lists as plan constants ("const",
    "inconst")."""
    tag = ir[0]
    if tag == "lit" and _fits(ir[1], ir[2]):
        return ("const", _const(p, ir[1], ir[2]), ir[2])
    if tag == "inints" and _fits(ir[2], ir[3]):
        return ("inconst", ir[1], _const(p, tuple(ir[2]), ir[3]), ir[3])
    if tag == "incodes" and ir[2]:
        return ("inconst", ir[1], _const(p, tuple(ir[2]), "i64"), "i64")
    return tuple(bind_ir(p, x) if isinstance(x, tuple) and x
                 and isinstance(x[0], str) else x for x in ir)


def bind_consts(p: _Plan, dev) -> None:
    """Move a planned program's constants onto the card: the literals and
    IN lists of its residuals, aggregate inputs and expression keys, and
    the direct path's key bounds."""
    p.stage_keys = tuple(_red_keys(p))
    p.resids = [bind_ir(p, ir) for ir in p.resids]
    p.rslots = [(kind, dt, bind_ir(p, ir), cols)
                for kind, dt, ir, cols in p.rslots]
    p.keys = [("expr", bind_ir(p, k[1]), k[2]) if isinstance(k, tuple)
              and k[0] == "expr" else k for k in p.keys]
    domains = _phys_domains(p) if p.keys else None
    if domains is not None:
        los = tuple(lo for lo, _ in domains)
        if _fits(los, "i64"):
            p.los_ix = _const(p, los, "i64")
    place_consts(p, dev)


def place_consts(p: _Plan, dev) -> None:
    """Upload the pending constants, one tensor per dtype, and point their
    array indices at views of it."""
    for dt, items in p.pending.items():
        if not items:
            continue
        flat: list = []
        for _ix, v, is_list in items:
            if is_list:
                flat.extend(v)
            else:
                flat.append(v)
        packed = to_device(torch.tensor(
            flat, dtype=torch.float64 if dt == "f64" else torch.int64), dev)
        k = 0
        for ix, v, is_list in items:
            n = len(v) if is_list else 1
            p.arrays[ix] = packed[k:k + n] if is_list else packed[k]
            k += n
        STATS["plan_consts"] += len(items)
        items.clear()


def _select_blocks(table, plan_scan) -> tuple:
    """Row-group stats pruning + batch zone-map pruning before any data
    IO -> tuple of (rg, batch)."""
    blocks = []
    for rg in table.prune_row_groups(plan_scan.stats_preds):
        for b in range(table.num_batches(rg)):
            dead = any(all(not table.batch_may_match(rg, c, b, pred)
                           for c, pred in g.alternatives)
                       for g in plan_scan.pushdown)
            if dead:
                table.zone_prunes += 1
            else:
                blocks.append((rg, b))
    return tuple(blocks)


def _collect_payloads(table, col, hint, blocks):
    """The given blocks of `col` as MEMORY_LIQUID payloads (read and
    cached on first use); raises _Bail if one is not liquid-encoded."""
    ids_by_rg: Dict[int, list] = {}
    eids = []
    for rg, b in blocks:
        ids = ids_by_rg.get(rg)
        if ids is None:
            ids = ids_by_rg[rg] = table.ensure_cached(rg, col, hint)
        eids.append(ids[b])
    cache = table.cache
    payloads = cache.liquid_payloads(eids)
    if payloads is None:
        bad = next((eid for eid in eids
                    if cache.entry_state(eid) != MEMORY_LIQUID), None)
        raise _Bail(f"block {bad} of {col} not MEMORY_LIQUID")
    return payloads


# -- the routes' per-table state ------------------------------------------------

#: cached (blocks-set) prep variants kept per column, and row-valid
#: stacks kept per table, oldest out first
_PREP_VARIANTS = 4

#: cached fused plans (and count(DISTINCT) plans) kept per table, oldest
#: out first (plans pin their prep stacks)
_PLAN_CACHE_CAP = 8


class PlanCache(OrderedDict):
    """Cached plans, at most `cap`, oldest out first; with `lru` a hit
    moves its plan last, so the least recently used leaves first.  The
    builds its plans pin (`fused_star._Build.pin`) refer to it weakly, so
    it lives no longer than its table or executor."""

    def __init__(self, cap: int, lru: bool = False):
        super().__init__()
        self.cap, self.lru = cap, lru

    def lookup(self, key):
        """The plan cached under `key`, or None."""
        hit = self.get(key)
        if hit is not None and self.lru:
            self.move_to_end(key)
        return hit

    def put(self, key, plan) -> None:
        if len(self) >= self.cap:
            self.popitem(last=False)
        self[key] = plan

    def drop_stale(self, key) -> None:
        """Drop the plans made under another catalog or cache epoch than
        `key` names (a star plan's key ends with the two): no later
        lookup makes their keys, and their arrays hold device tensors the
        budget does not charge."""
        for k in [k for k in self if k[-2:] != key[-2:]]:
            del self[k]


class TableState:
    """The fused routes' device state of one table between queries:
    `preps` (base column name -> {blocks: (payload generations, prep,
    bytes)}, each charged to the cache budget) and `rowvalid` (blocks ->
    live-row stack), `_PREP_VARIANTS` deep, oldest out first; `plans` and
    `distinct_plans` (the fused aggregate's and the device
    count(DISTINCT)'s, `PlanCache`); `stage_hints` (the hash ladder's
    clean stage per key set); `dim_builds` and `exist_builds` (the star
    route's `fused_star._Build`s, derived reservations of the column
    cache, least recently used out first).

    A wrapper's state (`derive`) holds its base's very objects for the
    memos it shares, and fresh ones for the rest (`SHARED`):

        wrapper                          shares with its base
        row-group slice (server/flight)  preps, rowvalid, dim_builds,
                                         exist_builds
        aliased relation (fused_star)    preps, rowvalid, dim_builds

    The shared memos are keyed by the block set, so a wrapper reuses and
    feeds its base's preps and builds (the builds under the base
    budget's one recency order).  Plans and stage hints are keyed
    without it: a plan made over one row group must never answer for
    the whole table.  A memo not named in `SHARED` stays apart."""

    SHARED = {"slice": ("preps", "rowvalid", "dim_builds", "exist_builds"),
              "alias": ("preps", "rowvalid", "dim_builds")}

    def __init__(self, cache):
        self.cache = cache  # the table's column cache (its budget)
        self.preps: Dict[str, dict] = {}
        self.rowvalid: Dict[tuple, torch.Tensor] = {}
        self.plans = PlanCache(_PLAN_CACHE_CAP)
        self.distinct_plans = PlanCache(_PLAN_CACHE_CAP)
        self.stage_hints: dict = {}
        self.dim_builds: dict = {}
        self.exist_builds: dict = {}

    def derive(self, wrapper: str) -> "TableState":
        """The state of a `wrapper` ("slice" or "alias") of this table."""
        st = TableState(self.cache)
        for name in self.SHARED[wrapper]:
            setattr(st, name, getattr(self, name))
        return st

    def release(self) -> None:
        """Release the preps' budget and the builds' reservations, and
        clear every memo (call when the table is dropped or replaced)."""
        for variants in self.preps.values():
            for ent in variants.values():
                self.cache.budget.release_memory(ent[2])
        for builds in (self.dim_builds, self.exist_builds):
            for probe in builds.values():
                probe.release()
        for memo in (self.preps, self.rowvalid, self.plans,
                     self.distinct_plans, self.stage_hints,
                     self.dim_builds, self.exist_builds):
            memo.clear()


def table_state(table) -> TableState:
    """The fused routes' state of `table`, made on first use.  It hangs
    on the table's `route_state`; a wrapper sets its own when it is made
    (`TableState.derive`)."""
    st = table.route_state
    if st is None:
        st = table.route_state = TableState(table.cache)
    return st


#: payload-identity generations for the prep and probe caches: `id()` can
#: be reused once a squeezed or evicted payload is freed; a generation
#: stamped on first sight cannot
_PAYLOAD_GEN = iter(range(1, 1 << 62)).__next__


def _gen_of(pp) -> int:
    g = getattr(pp, "_liquid_gen", None)
    if g is None:
        g = pp._liquid_gen = _PAYLOAD_GEN()
    return g


def _prep_nbytes(prep: _ColPrep) -> int:
    """Device bytes a cached prep holds (charged to the cache budget)."""
    n = 0
    for slot in ("planes_stack", "refs", "inv", "valid_stack", "lin_stack",
                 "codes_stack"):
        a = getattr(prep, slot)
        if a is not None:
            n += a.numel() * a.element_size()
    return n


def _table_prep(table, col, hint, blocks) -> _ColPrep:
    """Column prep cached in the table's state per (col, blocks),
    invalidated when a payload changes (squeeze, eviction, hydration: a
    new payload has a new generation, `_gen_of`).  A cached prep reserves
    its device bytes from the cache budget; when the budget is full it is
    served uncached."""
    payloads = _collect_payloads(table, col, hint, blocks)
    key = tuple(_gen_of(p) for p in payloads)
    field = table.field(col)  # an aliased relation's: the base's name
    variants = table_state(table).preps.setdefault(field.name, {})
    hit = variants.get(blocks)
    if hit is not None and hit[0] == key:
        return hit[1]
    prep = _prep_column(payloads, field.type, table.cache.device)
    budget = table.cache.budget
    if hit is not None:  # stale: drop and release
        variants.pop(blocks)
        budget.release_memory(hit[2])
    nbytes = _prep_nbytes(prep)
    if budget.try_reserve_memory(nbytes):
        if len(variants) >= _PREP_VARIANTS:
            budget.release_memory(variants.pop(next(iter(variants)))[2])
        variants[blocks] = (key, prep, nbytes)
    return prep


def _rowvalid(table, blocks) -> torch.Tensor:
    """Packed int32 [nb, 256]: the live rows of each block."""
    cache = table_state(table).rowvalid
    rv = cache.get(blocks)
    if rv is None:
        words = np.stack([mops.all_set_host(BLOCK_ROWS,
                                            table.batch_length(rg, b))
                          for rg, b in blocks])
        rv = words_to_tensor(words, table.cache.device)
        if len(cache) >= _PREP_VARIANTS:
            cache.pop(next(iter(cache)))
        cache[blocks] = rv
    return rv


def _kind_or(kind_of, c, default):
    """`kind_of(c)`, or `default` when column c has no fused kind; a
    decimal column bails the whole query to the classic path."""
    try:
        return kind_of(c)
    except _Bail as e:
        if str(e) == "decimal column":
            raise
        return default


def _schema_kind(t: pa.DataType) -> str:
    """Column kind from the arrow type alone (the zero-IO empty scan)."""
    if pa.types.is_dictionary(t):
        t = t.value_type
    if (pa.types.is_boolean(t) or pa.types.is_integer(t)
            or pa.types.is_date(t) or pa.types.is_timestamp(t)):
        return "planes"
    if pa.types.is_floating(t):
        return "float"
    if pa.types.is_decimal(t):
        raise _Bail("decimal column")
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_binary(t) or pa.types.is_large_binary(t)
            or pa.types.is_string_view(t) or pa.types.is_binary_view(t)):
        return "dict"
    raise _Bail(f"column type {t}")


def payload_bounds(prep: _ColPrep):
    """Global (lo, hi) value bounds of a planes/linear column from the
    per-block reference values and widths; None for floats."""
    if prep.kind == "planes":
        lo = min(pp.reference_value for pp in prep.payloads)
        hi = max(pp.reference_value + (1 << min(pp.width, 62)) - 1
                 for pp in prep.payloads)
        return int(lo), int(hi)
    if prep.kind == "linear":
        lo = hi = None
        for pp in prep.payloads:
            if isinstance(pp, LiquidLinearArray):
                r, lin = pp.residuals, round(pp.slope * (BLOCK_ROWS - 1))
            else:  # plain block in a mixed linear prep (slope 0)
                r, lin = pp, 0
            lb = r.reference_value + min(0, lin)
            hb = r.reference_value + (1 << min(r.width, 62)) - 1 + max(0, lin)
            lo = lb if lo is None else min(lo, lb)
            hi = hb if hi is None else max(hi, hb)
        return int(lo), int(hi)
    return None


def _expr_key_type(ge: ast.Expr, dt: str) -> pa.DataType:
    """Arrow type of an expression group key (the classic evaluator's
    typing)."""
    if isinstance(ge, ast.Cast) and ge.type_name == "date":
        return pa.date32()
    if isinstance(ge, ast.Extract):
        return pa.int32()
    if isinstance(ge, ast.Func) and ge.name in ("to_timestamp_seconds",
                                                "date_trunc"):
        return pa.timestamp("s")
    return pa.float64() if dt == "f64" else pa.int64()


def _plan_query(table, plan_scan, hints, key_names, slots, rew_keys,
                rew_inputs, eprobes=()) -> Tuple[_Plan, str, bool]:
    """Plan an aggregate -> (plan, "scalar" | "grouped", empty).  Raises
    _Bail.  `eprobes` are existence-probe specs (`exec.
    _plan_exist_probes`) run on this table's rows."""
    from liquid_tpu_torch.sql.device_agg import KeyCodec
    p = _Plan()
    for s in slots:
        if s.kind not in _AGG_KINDS:
            raise _Bail(f"aggregate kind {s.kind}")
    dev = table.cache.device

    blocks = _select_blocks(table, plan_scan)
    empty = not blocks

    pred_cols = {c for g in plan_scan.pushdown for c, _ in g.alternatives}
    for c in pred_cols:
        if c not in table.column_names:
            raise _Bail(f"unknown column {c}")
    needed = set(pred_cols)
    preps: Dict[str, _ColPrep] = {}

    def prep_of(c):
        pr = preps.get(c)
        if pr is None:
            pr = preps[c] = _table_prep(table, c, hints.get(c), blocks)
        return pr

    col_kinds: Dict[str, str] = {}

    def kind_of(c):
        if c not in col_kinds:
            if c not in table.column_names:
                raise _Bail(f"unknown column {c}")
            k = _schema_kind(table.field(c).type)  # no IO for strings
            if not empty:
                k = prep_of(c).kind
            col_kinds[c] = "planes" if k == "linear" else k
        return col_kinds[c]

    #: string columns whose vocabulary ids the program reads
    remap_cols: set = set()

    def vocab_of(c) -> list:
        """The sorted global vocabulary of string column c ([] when the
        scan is empty)."""
        if empty:
            return []
        pr = prep_of(c)
        _build_vocab(pr)
        remap_cols.add(c)
        return pr.vocab_list

    class _Kinds:
        def get(self, c, default=None):
            return _kind_or(kind_of, c, default)

        def arrow_type(self, c):
            if c in table.column_names:
                return table.field(c).type
            return None

        def vocab_eval(self, e, c):
            if empty or self.get(c) != "dict":
                return None
            return vocab_eval_expr(e, c, vocab_of(c))

        def lutres(self, e, c):
            """A numeric function of string column c, tabulated per
            vocabulary id -> (array index, dtype) or None."""
            vals = self.vocab_eval(e, c)
            if vals is None:
                return None
            if all(v is None or (isinstance(v, numbers.Integral)
                                 and not isinstance(v, bool)) for v in vals):
                arr = np.array([0 if v is None else int(v) for v in vals],
                               np.int64)
                return _add(p, to_device(torch.from_numpy(arr), dev)), "i64"
            if all(v is None or isinstance(v, numbers.Real) for v in vals):
                arr = np.array([0.0 if v is None else float(v)
                                for v in vals], np.float64)
                return _add(p, to_device(torch.from_numpy(arr), dev)), "f64"
            return None

    def dictres(c, op, lit):
        """String comparison on column c over its sorted vocabulary ->
        the matching ids, or None when c is not a string column."""
        if kinds_view.get(c) != "dict":
            return None
        vocab = vocab_of(c)
        if op == "=":
            return tuple(i for i, v in enumerate(vocab) if v == lit)
        if op == "like":
            pat = _like_regex(str(lit))
            return tuple(i for i, v in enumerate(vocab)
                         if v is not None and pat.match(str(v)))
        return None

    kinds_view = _Kinds()
    slot_irs: Dict[str, Tuple[tuple, set]] = {}
    for s in slots:
        if s.input is None:
            continue
        e = rew_inputs[s.name]
        is_dict = isinstance(e, ast.Column) and kind_of(e.name) == "dict"
        if is_dict and s.kind == "count":
            # count(string column): only its nullness is read
            slot_irs[s.name] = (("col", e.name, "i64"), {e.name})
        elif is_dict and s.kind in ("min", "max"):
            # sorted-vocabulary ids are value-ordered
            vocab = vocab_of(e.name)
            if vocab and vocab[-1] is None:
                raise _Bail("min/max over a NULL dictionary entry")
            p.slot_vocabs[s.name] = vocab
            slot_irs[s.name] = (("col", e.name, "i64"), {e.name})
            p.slot_types[s.name] = _value_type(table.field(e.name).type)
        else:
            slot_irs[s.name] = _compile_expr(e, kinds_view, dictres)
        needed |= slot_irs[s.name][1]
        if s.kind in ("min", "max") and isinstance(e, ast.Column) \
                and pa.types.is_uint64(table.field(e.name).type):
            raise _Bail("min/max over uint64")  # i64 order differs

    # avg(int) accumulates exactly in i64 only when bounds x rows < 2^62
    n_upper = len(blocks) * BLOCK_ROWS
    for s in slots:
        if s.kind != "avg" or s.name not in slot_irs:
            continue
        ir, cols_ = slot_irs[s.name]
        if _ir_dtype(ir) != "i64":
            continue
        safe = False
        if ir[0] == "col" and not empty:
            b = payload_bounds(prep_of(ir[1]))
            if b is not None:
                safe = max(abs(b[0]), abs(b[1])) * max(n_upper, 1) < (1 << 62)
        if not safe:
            slot_irs[s.name] = (_as_f64(ir), cols_)

    # residual conditions: boolean IR evaluated in the program
    for e in plan_scan.residual:
        ir, cols = _compile_bool(e, kinds_view, dictres)
        p.resids.append(ir)
        needed |= cols

    # a linear column has no packed interval form (values are not
    # monotone in the residual offsets): its groups become residual IR
    skip_groups: set = set()
    if not empty:
        for gi, g in enumerate(plan_scan.pushdown):
            if any(prep_of(c).kind == "linear" for c, _ in g.alternatives):
                ir, cols = _compile_bool(g.source, kinds_view, dictres)
                p.resids.append(ir)
                needed |= cols
                skip_groups.add(gi)

    # group keys: plain columns key by their decoded value, other
    # expressions compile to IR evaluated in the program
    mode = "grouped" if key_names else "scalar"
    for ge in rew_keys:
        if isinstance(ge, ast.Column):
            c = ge.name
            p.keys.append(c)
            if kind_of(c) == "dict":
                p.key_decoders.append(
                    ("vocab", vocab_of(c), _value_type(table.field(c).type)))
            else:
                p.key_decoders.append(("codec",
                                       KeyCodec(table.field(c).type)))
                if not empty and prep_of(c).kind == "planes":
                    p.key_payloads[c] = prep_of(c).payloads
                elif not empty and prep_of(c).kind == "linear":
                    # sorted keys (l_orderkey) are linear-coded: their
                    # block bounds give the dense domain direct
                    # addressing needs (1.5M orders at SF1 overflow the
                    # hash ladder's largest table)
                    p.key_bounds[c] = payload_bounds(prep_of(c))
            needed.add(c)
        else:
            try:
                ir, cols = _compile_expr(ge, kinds_view, dictres)
                skey = None
            except _Bail:
                # a string function of ONE string column: evaluated over
                # its vocabulary, keyed by the id in the mapped vocabulary
                skey = _string_key_lut(ge, kinds_view, p, dev)
                if skey is None:
                    raise
                ir, cols, mapped = skey
            dt = _ir_dtype(ir)
            p.keys.append(("expr", ir, dt))
            p.key_decoders.append(
                ("vocab", mapped, pa.string()) if skey is not None
                else ("codec", KeyCodec(_expr_key_type(ge, dt))))
            needed |= cols
    p.key_out = list(key_names)
    for sp in eprobes:
        for c in (sp["col"], sp["mmcol"]):
            if c is None:
                continue
            if kind_of(c) != "planes":
                raise _Bail(f"existence-probe column kind {kind_of(c)}")
            needed.add(c)

    if empty:
        _plan_slots(p, slots, slot_irs, rew_inputs, table)
        return p, mode, True

    for c in sorted(needed):
        register_col(p, c, prep_of(c), c in remap_cols)
    add_exist_probes(p, eprobes)

    for gi, g in enumerate(plan_scan.pushdown):
        if gi in skip_groups:
            continue
        p.pred_groups.append(tuple(pred_alt(p, c, pred, preps[c])
                                   for c, pred in g.alternatives))

    p.rv_ix = _add(p, _rowvalid(table, blocks))

    def bounds_of(c):
        if kind_of(c) == "planes":
            return payload_bounds(prep_of(c))
        return None

    def scaledres(c):
        if kind_of(c) == "float":
            return _scaled_col_info(p, c, prep_of(c))
        return None

    _plan_slots(p, slots, slot_irs, rew_inputs, table, bounds_of, scaledres,
                n_upper)
    bind_consts(p, dev)
    return p, mode, False


def add_exist_probes(p: _Plan, eprobes) -> None:
    """Put existence-probe specs into the plan (`exist_probes`)."""
    for sp in eprobes:
        pr = sp["probe"]
        mn = mx = -1
        if sp["mmcol"] is not None:
            if pr.minv is None:
                raise _Bail("existence probe without its min / max")
            mn, mx = _add(p, pr.minv), _add(p, pr.maxv)
        p.eprobes.append((sp["col"], _add(p, pr.cnt), _const(p, pr.lo, "i64"),
                          sp["mode"], mn, mx, sp["mmcol"] or ""))


def _prep_device(pr: _ColPrep) -> torch.device:
    return (pr.codes_stack if pr.kind == "dict" else pr.refs).device


def register_col(p: _Plan, c: str, pr: _ColPrep, gids: bool) -> None:
    """Put one column's stacked arrays into the plan's colmap; a string
    column reads its global vocabulary ids when `gids` is set (keys,
    residuals, payloads), else only its codes' nullness."""
    dev = _prep_device(pr)
    if pr.kind == "dict":
        ix = {"kind": "dict", "codes": _add(p, pr.codes_stack)}
        if gids:
            _build_vocab(pr)
            ix["gids"] = _add(p, _gid_stack(pr))
    else:
        ix = {"kind": pr.kind, "planes": _add(p, pr.planes_stack),
              "refs": _add(p, pr.refs)}
    if pr.kind == "float":
        ix["inv"] = _add(p, pr.inv)
        if pr.patch_rows is not None:
            ix["patch_rows"] = _add(p, to_device(torch.from_numpy(
                pr.patch_rows), dev))
            ix["patch_vals"] = _add(p, to_device(torch.from_numpy(
                pr.patch_vals), dev))
    if pr.kind == "linear":
        ix["lin"] = _add(p, pr.lin_stack)
    if pr.valid_stack is not None:
        ix["valid"] = _add(p, pr.valid_stack)
    p.colmap[c] = ix


def pred_alt(p: _Plan, c: str, pred: Predicate, pr: _ColPrep) -> tuple:
    """One pushdown alternative on column c, lowered for
    `_selection_packed`: ("iv", c, lo, hi, negate) per-block u64 bounds
    (K1's interval form), ("ivp", ...) with an ALP patch overlay, or
    ("lut", c, verdicts) over a string column's dictionary codes."""
    dev = _prep_device(pr)

    def bounds(a):
        return _add(p, to_device(torch.from_numpy(u64_to_i64(a)), dev))

    if pr.kind == "planes":
        iv = _primitive_interval(pr.payloads, pred)
        if iv is None:
            raise _Bail(f"predicate {pred.op} on {c}")
        lo, hi, neg = iv
        return ("iv", c, bounds(lo), bounds(hi), neg)
    if pr.kind == "float":
        iv = _float_interval(pr.payloads, pred)
        if iv is None:
            raise _Bail(f"float predicate {pred.op} on {c}")
        lo, hi, neg, clear, setw = iv
        alt = ("iv", c, bounds(lo), bounds(hi), neg)
        if clear is not None:
            alt = ("ivp",) + alt[1:] + (_add(p, words_to_tensor(clear, dev)),
                                        _add(p, words_to_tensor(setw, dev)))
        return alt
    lut = _dict_lut(pr.payloads, pred, pr.dmax)  # dict: verdicts per code
    if lut is None:
        raise _Bail(f"string predicate {pred.op} on {c}")
    return ("lut", c, _add(p, to_device(torch.from_numpy(lut), dev)))


def _scaled_col_info(p: _Plan, name: str, pr: _ColPrep):
    """(scale, maxabs) for an ALP column whose values are all exact
    scale-E decimals, registering its per-block multiplier ("smult") and
    the scaled images of its exception patches ("spatch"); None when the
    column cannot be an exact scaled integer."""
    exps = [pp.exponent for pp in pr.payloads]
    e_max = max(exps)
    if e_max > 6 or min(exps) < 0:
        return None
    spatch = None
    if pr.patch_rows is not None:
        s10 = float(10 ** e_max)
        pint = np.rint(pr.patch_vals * s10)
        if np.abs(pint).max(initial=0.0) >= float(1 << 52) \
                or not np.all(pint / s10 == pr.patch_vals):
            return None
        spatch = pint.astype(np.int64)
    mult = np.array([10 ** (e_max - e) for e in exps], np.int64)
    ma = 1
    for pp, mlt in zip(pr.payloads, mult):
        lo = int(pp.reference_value)
        hi = lo + (1 << pp.planes_np.shape[0]) - 1
        ma = max(ma, abs(lo * int(mlt)), abs(hi * int(mlt)))
    if spatch is not None:
        ma = max(ma, int(np.abs(spatch).max(initial=0)))
    if ma >= (1 << 62):
        return None
    ix = p.colmap.get(name)
    if ix is None:
        return None  # column not registered in this plan
    if "smult" not in ix:
        dev = pr.planes_stack.device
        ix["smult"] = _add(p, to_device(torch.from_numpy(mult), dev))
        if spatch is not None:
            ix["spatch"] = _add(p, to_device(torch.from_numpy(spatch), dev))
    return (e_max, ma)


def _plan_slots(p, slots, slot_irs, rew_inputs, table,
                bounds_of=None, scaledres=None, n_upper=0) -> None:
    """Reduction slots per aggregate, with each sum's |value| bound in
    `rslot_maxabs` (None = unbounded): the K2 gate and the f64-exact
    HAVING and top-k checks read it."""
    def maxabs_of(ir, dt):
        if dt != "i64" or bounds_of is None or ir[0] != "col":
            return None
        b = bounds_of(ir[1])
        return None if b is None else max(abs(b[0]), abs(b[1]), 1)

    for s in slots:
        base = len(p.rslots)
        if s.kind == "count_star":
            p.rslots.append(("sum", "i64", ("ones",), ()))
            p.rslot_maxabs.append(1)
        elif s.kind == "count":
            ir, cols = slot_irs[s.name]
            if ir[0] == "col":
                p.rslots.append(("sum", "i64", ("ones",), tuple(sorted(cols))))
            else:  # count(expr): rows where the expr is non-NULL
                p.rslots.append(("sum", "i64", ("nncount", ir), ()))
            p.rslot_maxabs.append(1)
        elif s.kind in ("sum", "avg", "min", "max"):
            ir, cols = slot_irs[s.name]
            dt = _ir_dtype(ir)
            red = s.kind if s.kind in ("min", "max") else "sum"
            sums = s.kind in ("sum", "avg")
            scaled = None
            if dt == "f64" and scaledres is not None:
                # exact i64 at a decimal scale; min/max too, so the host
                # division reproduces the exact decoded value
                scaled = _scaled_int_ir(ir, scaledres, bounds_of)
                if scaled is not None and sums \
                        and scaled[2] * max(n_upper, 1) >= (1 << 62):
                    scaled = None
            if scaled is not None:
                ir2, sc, ma = scaled
                p.rslots.append((red, f"i64s{sc}", ir2, tuple(sorted(cols))))
                p.rslot_maxabs.append(ma if sums else None)
            else:
                p.rslots.append((red, dt, ir, tuple(sorted(cols))))
                p.rslot_maxabs.append(maxabs_of(ir, dt) if sums else None)
            p.slot_types.setdefault(s.name, _slot_out_type(
                s, ir, rew_inputs.get(s.name), table))
        elif s.kind in ("stddev", "var"):
            ir, cols = slot_irs[s.name]
            ir = _as_f64(ir)
            p.rslots.append(("sum", "f64", ir, tuple(sorted(cols))))
            p.rslots.append(("sum", "f64", ("bin", "*", "f64", ir, ir),
                             tuple(sorted(cols))))
            p.rslot_maxabs += [None, None]
            p.slot_map.append((s.kind, (base, base + 1)))
            continue
        else:  # guarded in _plan_query
            raise _Bail(s.kind)
        p.slot_map.append((s.kind, (base,)))


def _slot_out_type(s, ir, input_expr, table) -> pa.DataType:
    dt = _ir_dtype(ir)
    if s.kind == "sum":
        if dt == "f64":
            return pa.float64()
        if isinstance(input_expr, ast.Column) and \
                pa.types.is_unsigned_integer(table.field(input_expr.name).type):
            return pa.uint64()
        return pa.int64()
    if s.kind in ("min", "max"):
        if isinstance(input_expr, ast.Column):
            return table.field(input_expr.name).type
        if isinstance(input_expr, ast.Cast) and input_expr.type_name == "date":
            return pa.date32()
        return pa.float64() if dt == "f64" else pa.int64()
    return pa.float64()


def _decode_slot_value(kind, t: pa.DataType, acc: np.ndarray,
                       cnt: np.ndarray, dt: str) -> pa.Array:
    """One slot's host decode (the reference's rules)."""
    if kind in ("count_star", "count"):
        return pa.array(acc, pa.int64())
    mask = cnt == 0
    m = mask if mask.any() else None
    if dt.startswith("i64s"):
        # exact scaled-int accumulation: value = acc / 10^scale
        v = _unscale_np(np.asarray(acc, np.int64), int(dt[4:]))
        if kind == "avg":
            with np.errstate(invalid="ignore", divide="ignore"):
                v = v / cnt.astype(np.float64)
        out = pa.array(v, pa.float64(), mask=m)
        if kind in ("min", "max") and pa.types.is_floating(t) \
                and t != pa.float64():
            out = out.cast(t)
        return out
    if kind == "sum":
        if dt == "f64":
            return pa.array(acc.view(np.float64), pa.float64(), mask=m)
        if pa.types.is_unsigned_integer(t):
            return pa.array(acc.view(np.uint64), pa.uint64(), mask=m)
        return pa.array(acc, pa.int64(), mask=m)
    if kind == "avg":
        v = acc.astype(np.float64) if dt == "i64" else acc.view(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = v / cnt.astype(np.float64)
        return pa.array(out, pa.float64(), mask=m)
    if kind in ("min", "max"):
        if dt == "f64":
            return pa.array(acc.view(np.float64), pa.float64(), mask=m).cast(
                t if pa.types.is_floating(t) else pa.float64())
        if pa.types.is_date32(t):
            return pa.array(acc.astype(np.int32), pa.int32(),
                            mask=m).view(pa.date32())
        if pa.types.is_date64(t) or pa.types.is_timestamp(t):
            return pa.array(acc, pa.int64(), mask=m).view(t)
        if pa.types.is_boolean(t):
            return pa.array(acc != 0, pa.bool_(), mask=m)
        return pa.array(acc, pa.int64(), mask=m).cast(t, safe=False)
    raise AssertionError(kind)


def _take_vocab(vocab: list, t: pa.DataType, ids: np.ndarray,
                mask: np.ndarray) -> pa.Array:
    """Vocabulary ids -> values of type t; masked rows are NULL."""
    if not len(vocab):
        return pa.nulls(len(ids), t)
    safe = np.clip(np.where(mask, 0, ids), 0, len(vocab) - 1)
    if 16 * len(safe) < len(vocab):
        # a few ids from a large vocabulary (q10's c_name, c_comment):
        # index the list; converting all of it costs ms per key per query
        vals = pa.array([vocab[i] for i in safe.tolist()], type=t)
    else:
        vals = pa.array(vocab, type=t).take(pa.array(safe.astype(np.int64)))
    if mask.any():
        vals = pc.if_else(pa.array(~mask), vals, pa.scalar(None, t))
    return vals


def _decode_slot(p: _Plan, name: str, kind, acc, cnt, j: int) -> pa.Array:
    t = p.slot_types.get(name, pa.int64())
    vocab = p.slot_vocabs.get(name)
    if vocab is not None and kind in ("min", "max"):
        # the extreme vocabulary id decodes to the extreme string
        return _take_vocab(vocab, t, np.asarray(acc, np.int64), cnt == 0)
    return _decode_slot_value(kind, t, acc, cnt, p.rslots[j][1])


def _value_type(t: pa.DataType) -> pa.DataType:
    return t.value_type if pa.types.is_dictionary(t) else t


def _finalize_scalar(p: _Plan, slots, outs: np.ndarray,
                     counts: np.ndarray) -> pa.Table:
    cols: Dict[str, pa.Array] = {}
    for s, (kind, idxs) in zip(slots, p.slot_map):
        j = idxs[0]
        acc = outs[j: j + 1]
        cnt = counts[j: j + 1]
        if kind in ("count_star", "count"):
            cols[s.name] = pa.array(cnt, pa.int64())
            continue
        if kind in ("stddev", "var"):
            ss = acc.view(np.float64)
            qq = outs[idxs[1]: idxs[1] + 1].view(np.float64)
            n = int(cnt[0])
            v = None
            if n > 1:
                var = max((qq[0] - ss[0] * ss[0] / n) / (n - 1), 0.0)
                v = var ** 0.5 if kind == "stddev" else var
            cols[s.name] = pa.array([v], pa.float64())
            continue
        cols[s.name] = _decode_slot(p, s.name, kind, acc, cnt, j)
    return pa.table(cols)


@contextmanager
def _issue():
    """The `fused.issue` span around one enqueue of a planned program; the
    uploads made inside it go to `STATS["issue_uploads"]` and, traced, to
    the span's `uploads`."""
    with TRACER.span("fused.issue") as span:
        n0 = COPIES["uploads"]
        try:
            yield
        finally:
            n = COPIES["uploads"] - n0
            STATS["issue_uploads"] += n
            if span is not None:
                span.attrs["uploads"] = n


def execute_plan(p: _Plan, mode: str, empty: bool, slots, table,
                 topk=None) -> Optional[pa.Table]:
    """Run a planned aggregate: the empty-scan shortcut, else the scalar
    program, the direct-address program or the hash ladder, and one
    fetch.  Returns the partial result (key columns + slot columns), or
    None when the ladder did not converge.  Spans: `fused.issue` around
    each enqueue of the program (`_issue`), `fused.finish` around the
    host's result building after its fetch."""
    nv = len(p.rslots)
    if empty:
        # every block pruned by stats/zones: typed result, zero data IO
        with TRACER.span("fused.finish"):
            if mode == "scalar":
                STATS["fused_scalar"] += 1
                return _finalize_scalar(p, slots, np.zeros(nv, np.int64),
                                        np.zeros(nv, np.int64))
            STATS["fused_grouped"] += 1
            nk = len(p.keys)
            return _build_result(p, slots, 0, [np.zeros(0, np.int64)] * nk,
                                 [np.zeros(0, bool)] * nk,
                                 [np.zeros(0, np.int64)] * nv,
                                 [np.zeros(0, np.int64)] * nv)
    if mode == "scalar":
        STATS["fused_scalar"] += 1
        with _issue():
            out = _fused_core(p)
        packed = to_host(out).numpy()
        with TRACER.span("fused.finish"):
            return _finalize_scalar(p, slots, packed[:nv], packed[nv:])

    STATS["fused_grouped"] += 1
    n_rows = int(p.arrays[p.rv_ix].shape[0]) * BLOCK_ROWS
    domains = _phys_domains(p)
    if domains is not None:
        m = 1
        for _, span in domains:
            m *= span + 2
        ncols = 1 + 2 * nv + 2 * len(_red_keys(p))
        cap = min(1 << 27, (3 << 30) // (8 * ncols))
        if 0 < m <= cap:
            los = (p.arrays[p.los_ix] if p.los_ix is not None else
                   to_device(torch.tensor([lo for lo, _ in domains],
                                          dtype=torch.int64),
                             p.arrays[p.rv_ix].device))
            grouped = ("direct", tuple(span for _, span in domains), los,
                       _k2_plan(p, m, n_rows), p.having or ())
            tkspec = _mk_topk_spec(topk, m)
            with _issue():
                out = _fused_core(p, grouped, tkspec)
            if tkspec:
                mini = to_host(out[3]).numpy()
                with TRACER.span("fused.finish"):
                    r = _finish_topk(p, slots, topk, mini)
                if r is not None:
                    return r
                with _issue():  # boundary tie: full fetch
                    out = _fused_core(p, grouped)
            with TRACER.span("fused.finish"):
                return _fetch_result(p, slots, out)

    hint_key = ("stage", _stage_keys(p))
    stage_hint = table_state(table).stage_hints
    # a static cardinality bound (int domain spans), capped by the row
    # count, picks a stage the ladder converges in without a retry; a
    # stage proven clean for this key set beats it
    bound = _cardinality_bound(p)
    bound = n_rows if bound is None else min(bound, n_rows)
    start = stage_hint.get(hint_key)
    if start is None:
        start = next((si for si, (ns, _) in enumerate(_STAGES)
                      if ns >= 2 * bound), len(_STAGES) - 1)
    for si in range(start, len(_STAGES)):
        n_slots, salt = _STAGES[si]
        # a birthday-safe table needs one scatter round
        rounds = 1 if bound * bound <= n_slots else 3
        grouped = ("hash", n_slots, salt, rounds)
        tkspec = _mk_topk_spec(topk, rounds * n_slots)
        with _issue():
            out = _fused_core(p, grouped, tkspec)
        # with top-k only the clean flag is fetched first
        mat = None if tkspec else to_host(out[0]).numpy()
        if not (bool(to_host(out[1])) if tkspec else mat[0, 0]):
            STATS["fused_retries"] += 1
            continue
        stage_hint[hint_key] = si
        if tkspec:
            mini = to_host(out[3]).numpy()
            with TRACER.span("fused.finish"):
                r = _finish_topk(p, slots, topk, mini)
            if r is not None:
                return r
            with _issue():
                out = _fused_core(p, grouped)
        with TRACER.span("fused.finish"):
            return _fetch_result(p, slots, out, mat)
    return None


def _k2_plan(p: _Plan, m: int, n_rows: int):
    """The reference's gates for K2 (`group_accumulate`): every slot an
    exact integer sum with a proven bound, the table within MAX_SLOTS,
    above the streaming crossover, each column's i32 plan feasible.
    -> (seg, ntab, wide) or ().  The crossover (6144) and the segment
    limits are TPU measurements, kept so the same queries take K2; the
    TPU-only backend check is the one gate dropped."""
    if not p.rslot_maxabs or any(b is None for b in p.rslot_maxabs) \
            or not all(r[0] == "sum" and (r[1] == "i64"
                                          or r[1].startswith("i64s"))
                       for r in p.rslots):
        return ()
    ntab = gh.plan_tables(m)
    if not (ntab and m + 1 <= gh.MAX_SLOTS
            and m * (1 + 2 * len(p.rslots)) > hops.STREAM_ELEMS):
        return ()
    plans = [gh.plan_hilo(n_rows, b) for b in p.rslot_maxabs]
    if any(pl is None for pl in plans) or n_rows % gh.TILE:
        return ()
    seg = min(pl[0] for pl in plans)
    wide = tuple(pl[1] > 0 for pl in plans)
    ncols = 1 + len(p.rslots) + sum(2 if w else 1 for w in wide)
    nseg = -(-(n_rows // gh.TILE) // seg)
    if ncols > gh.MAX_COLS or nseg > gh.MAX_SEGS \
            or nseg * (m + 8) * 512 > (2 << 30):
        return ()
    STATS["fused_pallas"] += 1
    return (seg, ntab, wide)


def _fetch_result(p: _Plan, slots, out, mat=None) -> pa.Table:
    """The packed matrix (fetched here unless given), or the slot-ordered
    columns re-packed when the groups overflow it."""
    if mat is None:
        mat = to_host(out[0]).numpy()
    g = int(mat[0, 1])
    if g <= mat.shape[1]:
        return _parse_packed(p, slots, mat, g)
    return _fetch_full(p, slots, g, out[3])


def _phys_domains(p: _Plan):
    """Domains of the keys the reduction runs on: the FD representative
    alone under a functional-dependency plan, else every group key."""
    if not p.fd:
        return _key_domains(p)
    kb = p.key_bounds.get(p.phys_keys[0])
    if kb is None or kb[1] - kb[0] >= (1 << 44):
        return None
    return [(kb[0], kb[1] - kb[0])]


def _key_domains(p: _Plan):
    """Per-key (lo, span) when every key's value domain is densely
    bounded (integer references and widths, star keys' payload bounds,
    vocabulary sizes); None otherwise.  Enables direct addressing:
    bijective slots, no collision passes."""
    out = []
    for name, dec in zip(p.keys, p.key_decoders):
        if dec[0] == "vocab":
            out.append((0, max(len(dec[1]), 1) - 1))
            continue
        kb = p.key_bounds.get(name) if isinstance(name, str) else None
        if kb is not None:
            if kb[1] - kb[0] >= (1 << 44):
                return None
            out.append((kb[0], kb[1] - kb[0]))
            continue
        payloads = p.key_payloads.get(name) if isinstance(name, str) \
            else None
        if not payloads or any(pp.width > 44 for pp in payloads):
            return None  # spans beyond ~17T are never direct-addressable
        lo = min(pp.reference_value for pp in payloads)
        hi = max(pp.reference_value + (1 << pp.width) - 1
                 for pp in payloads)
        out.append((lo, hi - lo))
    return out


def _cardinality_bound(p: _Plan) -> Optional[int]:
    """Upper bound on distinct key tuples from integer domain spans
    (payload widths; a linear-coded key's block bounds in `key_bounds`);
    None when a key is unbounded (floats, expressions)."""
    if p.fd:
        kb = p.key_bounds.get(p.phys_keys[0])
        return None if kb is None else max(min(kb[1] - kb[0] + 1, 1 << 62), 1)
    total = 1
    for name, dec in zip(p.keys, p.key_decoders):
        if dec[0] == "vocab":
            total = min(total * max(len(dec[1]), 1), 1 << 62)
            continue
        kb = p.key_bounds.get(name) if isinstance(name, str) else None
        if kb is not None:
            total = min(total * max(min(kb[1] - kb[0] + 1, 1 << 62), 1),
                        1 << 62)
            continue
        payloads = p.key_payloads.get(name) if isinstance(name, str) \
            else None
        if not payloads:
            return None
        lo = min(pp.reference_value for pp in payloads)
        hi = max(pp.reference_value + (1 << min(pp.width, 62)) - 1
                 for pp in payloads)
        total = min(total * max(min(hi - lo + 1, 1 << 62), 1), 1 << 62)
    return total


def _parse_packed(p: _Plan, slots, mat: np.ndarray, g: int) -> pa.Table:
    nk, nv = len(p.keys), len(p.rslots)
    r = 1
    ukeys = [mat[r + i][:g] for i in range(nk)]
    r += nk
    uknulls = [mat[r + i][:g].astype(bool) for i in range(nk)]
    r += nk
    outs = [mat[r + j][:g] for j in range(nv)]
    r += nv
    vcounts = [mat[r + j][:g] for j in range(nv)]
    return _build_result(p, slots, g, ukeys, uknulls, outs, vcounts)


def _fetch_full(p: _Plan, slots, g: int, cols) -> pa.Table:
    """More groups than the packed matrix holds: re-pack the slot-ordered
    outputs at the next power-of-two width (re-attaching the derived keys
    of an FD plan on the device) and fetch them bit-packed."""
    from liquid_tpu_torch.ops import packfetch
    nv = len(p.rslots)
    w2 = 1
    while w2 < g:
        w2 <<= 1
    ukeys, uknulls, outs, vcounts = hops.repack_groups(
        cols, len(_red_keys(p)), nv, w2)
    if p.fd:
        ukeys, uknulls = _fd_keys(ukeys[0], uknulls[0], p.fd, p.arrays)
    return _parse_full(p, slots, g, packfetch.fetch_columns(
        list(ukeys) + list(uknulls) + list(outs) + list(vcounts), g))


def _parse_full(p: _Plan, slots, g: int, cols) -> pa.Table:
    nk, nv = len(p.keys), len(p.rslots)
    return _build_result(
        p, slots, g, [c[:g] for c in cols[:nk]],
        [c[:g] for c in cols[nk:2 * nk]],
        [c[:g] for c in cols[2 * nk:2 * nk + nv]],
        [c[:g] for c in cols[2 * nk + nv:]])


def _build_result(p: _Plan, slots, g, ukeys, uknulls, outs,
                  vcounts) -> pa.Table:
    """Key columns decoded by their codecs, then the slot columns."""
    cols: Dict[str, pa.Array] = {}
    for name, dec, codes, nulls in zip(p.key_out, p.key_decoders, ukeys,
                                       uknulls):
        codes = np.ascontiguousarray(codes, np.int64)
        nulls = np.ascontiguousarray(nulls, bool)
        if dec[0] == "vocab":
            cols[name] = _take_vocab(dec[1], dec[2], codes, nulls)
        else:
            cols[name] = dec[1].decode(codes, nulls)
    for s, (kind, idxs) in zip(slots, p.slot_map):
        j = idxs[0]
        acc = np.ascontiguousarray(outs[j])
        cnt = np.ascontiguousarray(vcounts[j], np.int64)
        if kind == "avg2":
            # a device count(DISTINCT) route's avg: merged sum / merged count
            dt = p.rslots[j][1]
            sv = (acc.view(np.float64) if dt == "f64" else
                  _unscale_np(acc, int(dt[4:])) if dt.startswith("i64s")
                  else acc.astype(np.float64))
            cv = np.ascontiguousarray(outs[idxs[1]]).astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                v = sv / cv
            mask = cv == 0
            cols[s.name] = pa.array(v, pa.float64(),
                                    mask=mask if mask.any() else None)
            continue
        if kind in ("stddev", "var"):
            ss = acc.view(np.float64) if acc.dtype == np.int64 else acc
            q = np.ascontiguousarray(outs[idxs[1]])
            qq = q.view(np.float64) if q.dtype == np.int64 else q
            cc = cnt.astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                var = np.maximum((qq - ss * ss / cc) / (cc - 1.0), 0.0)
            mask = cnt <= 1
            cols[s.name] = pa.array(
                np.sqrt(var) if kind == "stddev" else var, pa.float64(),
                mask=mask if mask.any() else None)
            continue
        cols[s.name] = _decode_slot(p, s.name, kind, acc, cnt, j)
    if g == 0:
        return pa.table({k: v.slice(0, 0) for k, v in cols.items()})
    return pa.table(cols)


# -- device top-k and HAVING -----------------------------------------------
#
# ORDER BY <aggregate> [DESC] LIMIT k: the program gathers the top
# k2 = 4k + 64 occupied slots by the first order key and only those rows
# are fetched; the host finishes the full multi-key sort over them.  The
# answer is exact unless the k-th value ties the last fetched one -- then
# the full fetch runs (rare, never wrong).

TOPK_MARGIN = 64
TOPK_MAX = 4096


class TopKSpec:
    __slots__ = ("slot_index", "desc", "nulls_first", "k")

    def __init__(self, slot_index, desc, nulls_first, k):
        self.slot_index = slot_index
        self.desc = desc
        self.nulls_first = nulls_first
        self.k = k


_HAVING_OPS = {">": "gt", ">=": "ge", "<": "lt", "<=": "le",
               "=": "eq", "<>": "ne", "!=": "ne"}
_HAVING_FLIP = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge",
                "eq": "eq", "ne": "ne"}


def plan_having(q, slots, p: _Plan):
    """-> (rslot index, op, literal) when HAVING is one comparison of a
    sum/count aggregate with a numeric literal, exact in f64 by proven
    bounds; the host re-applies the predicate, so this only cuts the
    fetch."""
    if q is None or q.having is None:
        return None
    e = q.having
    if not (isinstance(e, ast.Binary) and e.op in _HAVING_OPS):
        return None
    l, r = e.left, e.right
    op = _HAVING_OPS[e.op]
    if isinstance(l, ast.Literal):
        l, r = r, l
        op = _HAVING_FLIP[op]
    if not (isinstance(r, ast.Literal) and isinstance(r.value, (int, float))
            and not isinstance(r.value, bool)):
        return None
    for si, s in enumerate(slots):
        if s.func != l:
            continue
        kind, idxs = p.slot_map[si]
        if kind not in ("sum", "count_star", "count"):
            return None
        j = idxs[0]
        dtj = p.rslots[j][1]
        lit = float(r.value)
        if (dtj == "i64" or dtj.startswith("i64s")) and kind == "sum":
            b = p.rslot_maxabs[j]
            n_upper = int(p.arrays[p.rv_ix].shape[0]) * BLOCK_ROWS
            if b is None or b * n_upper >= (1 << 53):
                return None  # the f64 compare could misorder
            if dtj.startswith("i64s"):
                lit = lit * (10 ** int(dtj[4:]))  # the scaled space
                if abs(lit) >= (1 << 53):
                    return None
        return (j, op, lit)
    return None


def plan_topk(q, slots, p: _Plan) -> Optional[TopKSpec]:
    """ORDER BY <aggregate> ... LIMIT k without HAVING -> TopKSpec: the
    first order key selects on the device, the host sorts the superset."""
    if q.limit is None or not q.order_by or q.having is not None:
        return None
    k = q.limit + (q.offset or 0)
    if k * 4 + TOPK_MARGIN > TOPK_MAX:
        return None
    o = q.order_by[0]
    e = o.expr
    alias_map = {it.alias: it.expr for it in q.items if it.alias}
    if isinstance(e, ast.Column) and e.name in alias_map:
        e = alias_map[e.name]
    for si, s in enumerate(slots):
        if s.func != e:
            continue
        kind, idxs = p.slot_map[si]
        if kind in ("stddev", "var", "avg2"):
            return None
        j = idxs[0]
        dtj = p.rslots[j][1]
        if (dtj == "i64" or dtj.startswith("i64s")) \
                and kind in ("sum", "avg", "min", "max") \
                and p.rslot_maxabs[j] is None:
            return None  # i64 ranks ride f64: exact only within 2^53
        nf = o.desc if o.nulls_first is None else o.nulls_first
        return TopKSpec((kind, idxs), bool(o.desc), bool(nf), k)
    return None


def _topk_gather_core(cols, spec, nk: int, nv: int) -> torch.Tensor:
    """The top-k2 occupied slot rows by the order value, packed into one
    int64 matrix [occ (+ nan flag << 32 in column 0), rank value, keys,
    key nulls, outs, counts] x k2."""
    kind, j_acc, _j_cnt, desc, nulls_first, k2 = spec
    occ = cols[0]
    acc = cols[1 + 2 * nk + j_acc]
    cnt = cols[1 + 2 * nk + nv + j_acc]
    val = acc if acc.dtype == torch.float64 else acc.to(torch.float64)
    if kind == "avg":
        val = val / cnt.clamp(min=1).to(torch.float64)
    # SQL NULL placement folded into the rank as huge FINITE sentinels:
    # -inf stays exclusive to unoccupied slots, so occupied rows stay a
    # prefix of the top k2
    null_rank = 1.7e308 if nulls_first == desc else -1.7e308
    val = torch.where(cnt == 0, torch.full_like(val, null_rank), val)
    nanflag = torch.isnan(val).any() | torch.isinf(
        torch.where(occ, val, torch.zeros_like(val))).any()
    rank = torch.where(occ, val if desc else -val,
                       torch.full_like(val, float("-inf")))
    _, idx = torch.topk(rank, k2)
    head = occ[idx].to(torch.int64)
    head[0] += nanflag.to(torch.int64) << 32
    return torch.stack([head, hops.as_i64(val)[idx]]
                       + [hops.as_i64(c)[idx] for c in cols[1:]])


def _mk_topk_spec(topk: Optional[TopKSpec], m: int) -> tuple:
    if topk is None:
        return ()
    kind, idxs = topk.slot_index
    k2 = min(topk.k * 4 + TOPK_MARGIN, int(m))
    return (kind, idxs[0], idxs[0], topk.desc, topk.nulls_first, k2)


def _finish_topk(p: _Plan, slots, topk: TopKSpec,
                 mini: np.ndarray) -> Optional[pa.Table]:
    """The fetched superset as a partial result, or None when exactness
    can't be certified (NaN ranks, or the k-th value ties the last)."""
    nk, nv = len(p.keys), len(p.rslots)
    if (mini[0, 0] >> 32) & 1:
        return None
    occ = (mini[0] & 0xFFFFFFFF).astype(bool)
    k2 = mini.shape[1]
    g2 = int(occ.sum())
    vals = mini[1].view(np.float64)
    if g2 == k2 and k2 > topk.k:
        # more groups exist beyond the fetch: exact iff the k-th value
        # beats the boundary strictly
        vk, vlast = vals[topk.k - 1], vals[g2 - 1]
        if not (vk > vlast if topk.desc else vk < vlast):
            return None
    rows = mini[2:, :g2]
    return _build_result(p, slots, g2, [rows[i] for i in range(nk)],
                         [rows[nk + i].astype(bool) for i in range(nk)],
                         [rows[2 * nk + j] for j in range(nv)],
                         [rows[2 * nk + nv + j] for j in range(nv)])


def _plan_cache_key(plan_scan, hints, group, key_names, slots, rew_keys,
                    rew_inputs, q):
    """Identity of everything _plan_query and the top-k / HAVING planning
    consume; paired with the cache epoch it keys a built plan.  Each
    expression enters whole (`repr`): its display name shows an IN list,
    a CASE or a subquery by its kind only."""
    parts = [tuple(key_names), bool(group),
             tuple(repr(e) for e in rew_keys),
             tuple((s.name, s.kind, repr(s.func)) for s in slots),
             tuple((s.name, repr(rew_inputs[s.name])) for s in slots
                   if s.name in rew_inputs),
             tuple(repr(g.source) for g in plan_scan.pushdown),
             tuple(repr(e) for e in plan_scan.residual),
             tuple(sorted((c, repr(h)) for c, h in (hints or {}).items()))]
    if q is not None:
        parts.append((q.limit, q.offset,
                      tuple((repr(o.expr), bool(o.desc), o.nulls_first)
                            for o in (q.order_by or ())),
                      repr(q.having)))
    return tuple(parts)


def try_fused_aggregate(table, plan_scan, hints, group, key_names, slots,
                        rew_keys, rew_inputs, q=None, eprobes=()
                        ) -> Optional[pa.Table]:
    """Run a single-table aggregate on the fused device path -> the
    partial result: key columns then slot columns (one row without GROUP
    BY).  `eprobes` are existence probes on the table's rows.  None when
    the shape is unsupported or the hash ladder does not resolve the key
    cardinality (`STATS["fused_bailouts"]`, the reason in
    `STATS["last_bail"]`): the classic path takes the query."""
    cache = table_state(table).plans
    with TRACER.span("fused.lookup"):
        # a probe's identity pins its build: a rebuilt probe is a new plan
        ck = (table.cache.epoch, _plan_cache_key(
            plan_scan, hints, group, key_names, slots, rew_keys, rew_inputs,
            q), tuple((sp["key"], sp["probe"].gen) for sp in eprobes))
        hit = cache.lookup(ck)
        if hit is None:
            with TRACER.span("fused.plan"):
                try:
                    hit = _plan_query(table, plan_scan, hints, key_names,
                                      slots, rew_keys, rew_inputs, eprobes)
                except _Bail as e:
                    hit = str(e)
            # a plan pins its existence builds' tensors: it is cached only
            # while every one of them is charged to the budget, and leaves
            # the cache when one of them is evicted
            if isinstance(hit, str) or all(sp["probe"].cached
                                           for sp in eprobes):
                cache.put(ck, hit)
                for sp in eprobes:
                    sp["probe"].pin(ck, cache)
    if isinstance(hit, str):  # a (cached) bailout
        STATS["fused_bailouts"] += 1
        STATS["last_bail"] = hit
        return None
    STATS["fused_queries"] += 1
    p, mode, empty = hit
    topk = None
    if q is not None and mode == "grouped" and not empty:
        topk = plan_topk(q, slots, p)
        p.having = plan_having(q, slots, p)
    result = execute_plan(p, mode, empty, slots, table, topk)
    if result is None:
        STATS["fused_bailouts"] += 1
        STATS["last_bail"] = "hash ladder did not converge"
    return result


# -- count(DISTINCT) ---------------------------------------------------------------
#
# Three routes, tried in the reference's order:
# - sorted pairs (`_first_pairs`): when the outer keys' cardinality is
#   bounded, ONE program sorts (keys, d), flags each distinct pair's first
#   row and reduces the flags per outer key in a small hash table;
# - chained two-level hash: level 1 groups by (keys, d) with the partial
#   aggregates riding along, level 2 re-reduces level 1's slot arrays by
#   the outer keys in the same program, and only the final rows transfer;
# - the host fold (`distinct_two_level`): one fused aggregate grouped by
#   (keys, d...) and a pyarrow fold over its rows, for the shapes the
#   device routes refuse (two DISTINCT columns, a star join, a ladder that
#   does not converge).

def _distinct_partials(slots, rew_inputs, prefix: str):
    """The inner aggregate slots of a count(DISTINCT) rewrite -> (inner
    slots, recipes, level-2 kinds, level-2 slot map, [(outer name, inner
    name)] of the min/max/sum slots), or None for an aggregate the rewrite
    cannot split.  Recipes: ("nunique",), ("out", inner slot index)."""
    from liquid_tpu_torch.sql.physical import AggSlot
    inner: List = []
    recipes: List[tuple] = []
    kinds2: List[str] = []
    slot_map2: List[tuple] = []
    typed: List[tuple] = []

    def partial(kind, inp):
        inner.append(AggSlot(ast.Func(
            kind if kind != "count_star" else "count",
            (inp,) if inp is not None else (), star=inp is None),
            f"{prefix}{len(inner)}", kind, inp))
        return len(inner) - 1

    for s in slots:
        base = len(recipes)
        if s.kind == "count_distinct":
            recipes.append(("nunique",))
            kinds2.append("sum")
            slot_map2.append(("count_star", (base,)))
        elif s.kind in ("count_star", "count"):
            recipes.append(("out", partial(s.kind, rew_inputs.get(s.name))))
            kinds2.append("sum")
            slot_map2.append(("count_star", (base,)))
        elif s.kind in ("sum", "min", "max"):
            j1 = partial(s.kind, rew_inputs[s.name])
            recipes.append(("out", j1))
            kinds2.append(s.kind)
            slot_map2.append((s.kind, (base,)))
            typed.append((s.name, inner[j1].name))
        elif s.kind == "avg":
            recipes.append(("out", partial("sum", rew_inputs[s.name])))
            recipes.append(("out", partial("count", rew_inputs[s.name])))
            kinds2 += ["sum", "sum"]
            slot_map2.append(("avg2", (base, base + 1)))
        else:
            return None
    return inner, recipes, kinds2, slot_map2, typed


def _distinct_columns(slots, rew_inputs) -> Optional[List[str]]:
    """The DISTINCT columns in slot order, or None when one is not a
    plain column."""
    dcols: List[str] = []
    for s in slots:
        if s.kind != "count_distinct":
            continue
        e = rew_inputs.get(s.name)
        if not isinstance(e, ast.Column):
            return None
        if e.name not in dcols:
            dcols.append(e.name)
    return dcols


def _plan_distinct(table, plan_scan, hints, group, key_names, slots,
                   rew_keys, rew_inputs):
    """Level-1 plan (keys + [d]) and the level-2 pseudo-plan the result
    decode and top-k read -> (p1, p2, recipes, kinds2), or None when the
    device routes do not take the query."""
    dcols = _distinct_columns(slots, rew_inputs)
    if not dcols or len(dcols) != 1:
        return None
    d = dcols[0]
    got = _distinct_partials(slots, rew_inputs, "__dp")
    if got is None:
        return None
    inner, recipes, kinds2, slot_map2, typed = got
    rew_inputs2 = {s.name: s.input for s in inner if s.input is not None}
    try:
        p1, mode, empty = _plan_query(
            table, plan_scan, hints, list(key_names) + [f"__dk_{d}"], inner,
            list(rew_keys) + [ast.Column(d)], rew_inputs2)
    except _Bail:
        return None
    if mode != "grouped" or empty or p1.fd:
        return None
    p2 = _Plan()
    p2.keys = p1.keys[:-1]
    p2.key_out = list(key_names)
    p2.key_decoders = p1.key_decoders[:-1]
    p2.key_bounds = dict(p1.key_bounds)
    p2.key_payloads = dict(p1.key_payloads)
    p2.slot_map = slot_map2
    p2.arrays = p1.arrays
    p2.rv_ix = p1.rv_ix
    for s in slots:
        if s.kind == "count_distinct":
            p2.slot_types[s.name] = pa.int64()
    for outer, inner_nm in typed:
        p2.slot_types[outer] = p1.slot_types.get(inner_nm, pa.int64())
        if inner_nm in p1.slot_vocabs:
            # string min/max by vocabulary id: the same sorted vocabulary
            p2.slot_vocabs[outer] = p1.slot_vocabs[inner_nm]
    for r, k2 in zip(recipes, kinds2):
        if r[0] == "nunique":
            p2.rslots.append(("sum", "i64", ("ones",), ()))
            p2.rslot_maxabs.append(1)
        else:
            r1 = p1.rslots[r[1]]
            p2.rslots.append((k2, r1[1], r1[2], r1[3]))
            p2.rslot_maxabs.append(None)
    return p1, p2, tuple(recipes), tuple(kinds2)


def _distinct_chained(p1: _Plan, recipes, kinds2, stage1, stage2):
    """Level 1 grouped by (keys, d) on the hash ladder, level 2 over its
    slot arrays by the outer keys: nunique(d) is the sum of the occupied
    slots whose d is not NULL."""
    _mat1, clean1, _ng1, cols1 = _fused_core(p1, ("hash",) + stage1)
    nk1, nv1 = len(p1.keys), len(p1.rslots)
    occ = cols1[0]
    kreps = cols1[1:1 + nk1]
    nreps = cols1[1 + nk1:1 + 2 * nk1]
    ocat = cols1[1 + 2 * nk1:1 + 2 * nk1 + nv1]
    ccat = cols1[1 + 2 * nk1 + nv1:]
    d_live = ~nreps[-1].to(torch.bool) & occ
    vals2, vnulls2 = [], []
    for r in recipes:
        if r[0] == "nunique":
            vals2.append(d_live.to(torch.int64))
            vnulls2.append(~d_live)
        else:
            vals2.append(ocat[r[1]])
            vnulls2.append(ccat[r[1]] == 0)
    mat2, clean2, ng2, cols2 = hops.hash_rounds_reduce_packed(
        [k.to(torch.int64) for k in kreps[:-1]],
        [nl.to(torch.bool) for nl in nreps[:-1]], occ, vals2, vnulls2,
        kinds2, *stage2)
    return mat2, clean1 & clean2, ng2, cols2


def distinct_fused_device(table, plan_scan, hints, group, key_names, slots,
                          rew_keys, rew_inputs, q=None) -> Optional[pa.Table]:
    """count(DISTINCT d) over one parquet source on the device -> the
    partial result (key columns + slot columns), or None when neither
    device route takes the query (the caller runs the host fold)."""
    if not any(s.kind == "count_distinct" for s in slots):
        return None
    # planned once per shape, as the fused aggregate is (None: no route)
    state = table_state(table)
    cache = state.distinct_plans
    with TRACER.span("fused.lookup"):
        ck = (table.cache.epoch, _plan_cache_key(
            plan_scan, hints, group, key_names, slots, rew_keys, rew_inputs,
            q))
        if ck not in cache:
            with TRACER.span("fused.plan"):
                cache.put(ck, _plan_distinct(table, plan_scan, hints, group,
                                             key_names, slots, rew_keys,
                                             rew_inputs))
        planned = cache[ck]
    if planned is None:
        return None
    p1, p2, recipes, kinds2 = planned
    n_upper = int(p1.arrays[p1.rv_ix].shape[0]) * BLOCK_ROWS
    bound = _cardinality_bound(p1)
    bound = n_upper if bound is None else min(bound, n_upper)
    start = next((si for si, (ns, _) in enumerate(_STAGES_XL)
                  if ns >= 2 * bound), None)
    if start is None:
        return None  # even the largest table cannot promise convergence
    topk = plan_topk(q, slots, p2) if q is not None else None
    stage_hint = state.stage_hints

    def finish(out, hk, si):
        if not bool(to_host(out[1])):
            STATS["fused_retries"] += 1
            return None
        stage_hint[hk] = si
        STATS["fused_queries"] += 1
        STATS["fused_grouped"] += 1
        if topk is not None:
            cols = out[3]
            with _issue():
                mini = _topk_gather_core(cols, _mk_topk_spec(
                    topk, int(cols[0].shape[0])), len(p2.keys),
                    len(p2.rslots))
            mini = to_host(mini).numpy()
            with TRACER.span("fused.finish"):
                r = _finish_topk(p2, slots, topk, mini)
            if r is not None:
                return r
        with TRACER.span("fused.finish"):
            return _fetch_result(p2, slots, out)

    # sorted pairs: the table needs only 2x the OUTER keys' cardinality
    kb = _cardinality_bound(p2)
    if kb is not None:
        hk = ("stage2sort", _stage_keys(p1))
        s0 = stage_hint.get(hk, next((si for si, (ns, _) in enumerate(
            _STAGES_XL) if ns >= 2 * kb), None))
        if s0 is not None:
            for si in range(s0, len(_STAGES_XL)):
                n2, s2 = _STAGES_XL[si]
                with _issue():
                    out = _fused_core(p1, ("sortpairs", recipes, kinds2, n2,
                                           s2, 3))
                r = finish(out, hk, si)
                if r is not None:
                    STATS["distinct_sort"] += 1
                    return r
            return None

    # chained (the outer keys have no bound, or one beyond the ladder): the
    # row-capped bound is pessimistic, so start at 1M slots at most and let
    # the dirty check grow the table; level 2 takes a table as large
    hk = ("stage2", _stage_keys(p1))
    start = stage_hint.get(hk, min(start, 2))
    for si in range(start, len(_STAGES_XL)):
        n_slots, salt = _STAGES_XL[si]
        with _issue():
            out = _distinct_chained(
                p1, recipes, kinds2, (n_slots, salt, 3),
                (n_slots, salt ^ 0x5851F42D4C957F2D, 3))
        r = finish(out, hk, si)
        if r is not None:
            STATS["distinct_chained"] += 1
            return r
    return None


def distinct_two_level(slots, group, key_names, rew_keys, rew_inputs,
                       run_inner) -> Optional[pa.Table]:
    """agg(DISTINCT col) through ONE fused aggregate grouped by keys +
    [distinct columns] -- the other aggregates ride as exact partials:
    sums of sums, min of mins, avg as sum and count -- and a pyarrow fold
    over its rows (NULL keys form one group).  `run_inner(group2,
    key_names2, slots2, rew_keys2, rew_inputs2)` runs the inner aggregate
    on the caller's fused engine (single table or star), None when it
    cannot.  None when the query has no count(DISTINCT) over plain
    columns or the inner aggregate does not run."""
    dcols = _distinct_columns(slots, rew_inputs)
    if not dcols:
        return None
    got = _distinct_partials(slots, rew_inputs, "__cd")
    if got is None:
        return None
    inner_slots, recipes, _k2, _map2, _typed = got
    group2 = list(group) + [(ast.Column(d), f"__dk_{d}") for d in dcols]
    inner = run_inner(group2, [nm for _, nm in group2], inner_slots,
                      list(rew_keys) + [ast.Column(d) for d in dcols],
                      {s.name: s.input for s in inner_slots
                       if s.input is not None})
    if inner is None:
        return None
    keyn = [nm for _, nm in group]
    # per outer slot: the inner columns it folds and how.  Counts add with
    # min_count 0 (an empty scan without keys counts 0); sums of a group
    # whose partials are all NULL stay NULL; avg folds sum and count apart
    folds: List[tuple] = []
    it = iter(recipes)
    for s in slots:
        r = next(it)
        if s.kind == "count_distinct":
            folds.append((s, [(f"__dk_{rew_inputs[s.name].name}",
                               "count_distinct")], pa.int64()))
        elif s.kind == "avg":
            r2 = next(it)
            folds.append((s, [(inner_slots[r[1]].name, "sum0"),
                              (inner_slots[r2[1]].name, "sum0")],
                          pa.float64()))
        elif s.kind in ("count_star", "count"):
            folds.append((s, [(inner_slots[r[1]].name, "sum0")],
                          pa.int64()))
        else:
            nm = inner_slots[r[1]].name
            folds.append((s, [(nm, s.kind)], inner.schema.field(nm).type))
    pa_aggs = []
    for _s, parts, _t in folds:
        for col, op in parts:
            if op == "count_distinct":
                pa_aggs.append((col, op, pc.CountOptions(mode="only_valid")))
            elif op == "sum0":
                pa_aggs.append((col, "sum",
                                pc.ScalarAggregateOptions(min_count=0)))
            else:
                pa_aggs.append((col, op))
    folded = inner.group_by(keyn, use_threads=False).aggregate(pa_aggs)
    # the aggregates in order (pyarrow versions put the keys first or last)
    fcols = [folded.column(i).combine_chunks()
             for i, nm in enumerate(folded.column_names) if nm not in keyn]
    assert len(fcols) == len(pa_aggs)
    if not keyn and not inner.num_rows:
        # no keys, no rows: one row of 0 counts and NULLs
        fcols = [pa.array([0 if op in ("count_distinct", "sum0") else None],
                          pa.int64()) for _s, parts, _t in folds
                 for _c, op in parts]
    out: Dict[str, pa.Array] = {
        nm: folded.column(nm).cast(inner.schema.field(nm).type)
        for nm in keyn}
    fi = 0
    for s, parts, t in folds:
        if s.kind == "avg":
            sv = np.asarray(fcols[fi].cast(pa.float64()).to_numpy(
                zero_copy_only=False), np.float64)
            cv = np.asarray(fcols[fi + 1].to_numpy(zero_copy_only=False),
                            np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                v = sv / cv
            out[s.name] = pa.array(v, pa.float64(), mask=cv == 0)
        else:
            out[s.name] = fcols[fi].cast(t)
        fi += len(parts)
    STATS["distinct_fold"] += 1
    return pa.table(out)


# -- fused bare SELECT (filter -> order -> LIMIT k row fetch) ----------------------
#
# `SELECT cols FROM t WHERE ... ORDER BY expr LIMIT k` (ClickBench q24,
# q26): the device computes the ids of the k2 = SELECT_K_CAP best rows by
# the first order key (selection, decode, a stable sort of the rank) and
# the host reads only those rows' cells from the cached blocks, then sorts
# them by every order key.  Exact unless the k-th rank ties the k2-th.
# The reference fetches k2 = 4k + 64 and hands such a tie to its classic
# path; the device sorts every row whatever k2 is, so the port fetches the
# cap at once (ClickBench's EventTime repeats about 160 times per value at
# 4M rows).  A tie at the cap, a NaN order key, a nullable one and an
# unordered scan too large to fetch go to the classic path, as every
# other shape the fused select does not take.  Only the rows ranked no
# later than the k-th are read: the others cannot reach the first k.

SELECT_K_CAP = 4096


def _fused_select_run(p: _Plan, resids, oir, desc: bool, k2: int):
    """-> (count of selected rows, -1 when a selected order key is NaN;
    int64 row ids [k2]; f64 ranks [k2], ascending)."""
    arrays = p.arrays
    sel = _selection_packed(p.colmap, p.pred_groups, arrays,
                            arrays[p.rv_ix])
    selb = mops.unpack_bits(sel).reshape(-1)
    n = selb.shape[0]
    env = _Decoders(p.colmap, arrays, n, selb.device)
    for ir in resids:
        selb = selb & _bool_nonnull(ir, env)
    count = selb.sum(dtype=torch.int64)
    if oir is None:
        # the first k2 selected rows in row order
        pos = torch.cumsum(selb.to(torch.int32), 0, dtype=torch.int32)
        want = torch.arange(1, k2 + 1, dtype=torch.int32, device=selb.device)
        src = torch.searchsorted(pos, want).clamp(0, n - 1)
        return count, src.to(torch.int64), torch.zeros(
            k2, dtype=torch.float64, device=selb.device)
    v, nl = eval_ir_nulls(oir, env)
    val = v.expand(selb.shape).to(torch.float64)
    nl = nl.expand(selb.shape)
    count = torch.where((torch.isnan(val) & selb).any(),
                        torch.full_like(count, -1), count)
    inf = torch.full((), float("inf"), dtype=torch.float64,
                     device=selb.device)
    rank = torch.where(selb & ~nl, -val if desc else val, inf)
    # `jax.lax.top_k` puts the lower row id first among equal values; a
    # stable ascending sort of the rank picks the same k2 rows
    ranks, idx = torch.sort(rank, stable=True)
    return count, idx[:k2], ranks[:k2]


class _Refused(Exception):
    """A bare SELECT the fused select does not take."""


def try_fused_select(executor, table, q, where) -> Optional[pa.Table]:
    """A bare single-table SELECT on the device: LIMIT queries ordered by
    one leading numeric or string expression (further keys sort on the
    host over the fetched superset), and small unordered filters.  None
    for every shape it does not take (`STATS["select_bailouts"]`, the
    reason in `STATS["last_bail"]`): the classic path takes it."""
    try:
        return _fused_select(executor, table, q, where)
    except _Refused as e:
        STATS["select_bailouts"] += 1
        STATS["last_bail"] = str(e)
        return None


def _fused_select(executor, table, q, where) -> pa.Table:
    from liquid_tpu_torch.sql.eval import Batch, Evaluator
    from liquid_tpu_torch.sql.fused_star import (_MiniPlanner,
                                                 _prep_has_nulls,
                                                 _register_col)
    from liquid_tpu_torch.sql.physical import collect_columns, render
    from liquid_tpu_torch.sql.planner import plan_scan_filters
    if q.distinct:
        raise _Refused("SELECT DISTINCT")
    if any(isinstance(it.expr, ast.Star) for it in q.items):
        raise _Refused("SELECT *")
    if any(o.nulls_first is not None for o in q.order_by):
        raise _Refused("a stated NULLS FIRST / LAST")
    k = (q.limit + (q.offset or 0)) if q.limit is not None else None
    if k is not None and k * 4 + 64 > SELECT_K_CAP:
        raise _Refused(f"LIMIT {k} (more than {SELECT_K_CAP} rows "
                              f"to fetch)")
    if q.order_by and k is None:
        raise _Refused("ORDER BY without LIMIT")
    try:
        plan_scan = plan_scan_filters(where)
        blocks = _select_blocks(table, plan_scan)
        p = _Plan()
        mp = _MiniPlanner(table, blocks)
        kinds_view = _MiniPlanner._KV(mp)
        registered: set = set()
        resids: List[tuple] = []

        def reg_ir(ir, cols):
            resids.append(ir)
            for c in sorted(cols):
                _register_col(p, mp, None, c, registered,
                              mp.kind_of(c) == "dict")

        if blocks:
            for g in plan_scan.pushdown:
                if any(mp.prep_of(None, c).kind == "linear"
                       for c, _pr in g.alternatives):
                    # no packed interval over linear codes: residual IR
                    reg_ir(*_compile_bool(g.source, kinds_view, mp.dictres))
                    continue
                alts = []
                for c, pred in g.alternatives:
                    _register_col(p, mp, None, c, registered)
                    alts.append(pred_alt(p, c, pred, mp.prep_of(None, c)))
                p.pred_groups.append(tuple(alts))
            for e in plan_scan.residual:
                reg_ir(*_compile_bool(e, kinds_view, mp.dictres))
        oir, desc = None, False
        if q.order_by and blocks:
            o0 = q.order_by[0]
            desc = bool(o0.desc)
            if isinstance(o0.expr, ast.Column) \
                    and mp.kind_of(o0.expr.name) == "dict":
                # sorted-vocabulary ids order as the strings do
                oir, ocols = ("col", o0.expr.name, "i64"), {o0.expr.name}
            else:
                oir, ocols = _compile_expr(o0.expr, kinds_view, mp.dictres)
            for c in sorted(ocols):
                pr = mp.prep_of(None, c)
                if _prep_has_nulls(table, pr, blocks):
                    raise _Bail("a nullable order key")
                _register_col(p, mp, None, c, registered, pr.kind == "dict")
    except _Bail as e:
        raise _Refused(str(e)) from None
    if k is None:
        k = SELECT_K_CAP // 4  # unordered without LIMIT: small results only
    k2 = SELECT_K_CAP
    idx = np.zeros(0, np.int64)
    if blocks:
        p.rv_ix = _add(p, _rowvalid(table, blocks))
        resids = [bind_ir(p, ir) for ir in resids]
        oir = None if oir is None else bind_ir(p, oir)
        place_consts(p, table.cache.device)
        count_t, idx_t, ranks_t = _fused_select_run(p, resids, oir, desc, k2)
        # one fetch: [count, ids..., ranks...]
        packed = to_host(torch.cat([count_t.to(torch.float64).reshape(1),
                                    idx_t.to(torch.float64),
                                    ranks_t])).numpy()
        count = int(packed[0])
        if count < 0:
            raise _Refused("a NaN order key (the host's NaN order)")
        got = packed[1:1 + k2].astype(np.int64)
        ranks = packed[1 + k2:]
        if q.order_by and count > k2 and (not np.isfinite(ranks[k2 - 1])
                                          or not ranks[k - 1] < ranks[k2 - 1]):
            raise _Refused("a tie at the fetched boundary")
        if q.limit is None and count > k2:
            raise _Refused(f"an unordered scan of {count} rows")
        take = min(count, k2)
        idx = got[:take]
        if q.order_by and take:
            # rows ranked after the k-th cannot reach the first k
            idx = idx[ranks[:take] <= ranks[min(k, take) - 1]]

    # the selected rows' cells, from each block decoded once
    needed: set = set()
    for it in q.items:
        collect_columns(it.expr, needed)
    for o in q.order_by:
        collect_columns(o.expr, needed)
    need = sorted(c for c in needed if c in table.column_names)
    blocks_arr: Dict[tuple, pa.Array] = {}

    def block(bi: int, c: str) -> pa.Array:
        rg, b = blocks[bi]
        arr = blocks_arr.get((rg, b, c))
        if arr is None:
            arr = table.cache.get(table.ensure_cached(rg, c)[b])
            if arr is None:
                raise _Refused(f"an uncached block of {c}")
            blocks_arr[(rg, b, c)] = arr
        return arr

    cols_in = {}
    for c in need:
        t = table.field(c).type
        cells = [block(int(r) // BLOCK_ROWS, c)[int(r) % BLOCK_ROWS]
                 for r in idx]
        cols_in[c] = pa.array([v.as_py() for v in cells], t)
    n_rows = len(idx)
    ev = Evaluator(Batch(cols_in, n_rows))
    cols_out: Dict[str, pa.Array] = {}
    names, sort_keys = [], []
    for it in q.items:
        nm = it.alias or render(it.expr)
        v = ev.eval(it.expr)
        cols_out[nm] = pa.repeat(v, n_rows) if isinstance(v, pa.Scalar) \
            else v
        names.append(nm)
    for i, o in enumerate(q.order_by):
        nm = f"__fsel{i}"
        v = ev.eval(o.expr)
        cols_out[nm] = pa.repeat(v, n_rows) if isinstance(v, pa.Scalar) \
            else v
        sort_keys.append((nm, "descending" if o.desc else "ascending"))
    t = pa.table(cols_out)
    if sort_keys:
        t = t.take(pc.sort_indices(t, sort_keys=sort_keys))
    if q.offset:
        t = t.slice(q.offset)
    if q.limit is not None:
        t = t.slice(0, q.limit)
    STATS["fused_queries"] += 1
    STATS["fused_selects"] += 1
    return t.select(names)
