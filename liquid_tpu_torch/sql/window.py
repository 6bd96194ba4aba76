"""Window functions over a materialized table (port of
`liquid_tpu/sql/window.py`).

The standard set, as in the reference:

- ranking: row_number, rank, dense_rank, ntile
- navigation: lag, lead, first_value, last_value
- framed aggregates: sum, count, avg, min, max

Frames: the SQL defaults (RANGE UNBOUNDED PRECEDING..CURRENT ROW with
ORDER BY, the whole partition without), ROWS and RANGE with unbounded or
current bounds, and bounded ROWS and RANGE offsets (a RANGE offset takes
one numeric or date order key, in days for a date).

Algorithm, the reference's on numpy and pyarrow (the card's host has no
pandas): exact dense codes per key from `pc.rank` (so large int64
values, strings and decimals never collapse into false ties; a NULL is
its own code, a float NaN ranks above every number), one stable lexsort
over (partition keys, order keys), and then per row a frame [lo, hi] in
the sorted domain.  Sums, averages and counts read segmented prefix
scans at the frame's ends; min and max reduce the values' dense codes
over the frame with a sparse table, so strings, dates and decimals take
the same path as numbers.  Results gather back to input order with one
`take`.  This is host work over the inner query's result, which the
engine's routes compute on the device.

Where the reference is wrong, the port follows SQL: first_value and
last_value read the frame (the reference reads the partition's first
row and, for RANGE, the peer group's end), a frame whose preceding
offset leaves the partition is cut at its start, an ``UNBOUNDED
PRECEDING..k FOLLOWING`` RANGE frame follows values rather than rows,
integer sums are exact in int64, and a float NaN stays a value rather
than a NULL.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from liquid_tpu_torch.sql import ast

WINDOW_FUNCS = {
    "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
    "first_value", "last_value", "sum", "count", "avg", "min", "max",
}


def find_windows(e, out: List[ast.WindowFunc]) -> None:
    """Collect distinct WindowFunc nodes (structural dedup)."""
    if isinstance(e, ast.WindowFunc):
        if e not in out:
            out.append(e)
        return
    for f_ in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f_)
        if isinstance(v, ast.Expr):
            find_windows(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, ast.Expr):
                    find_windows(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Expr):
                            find_windows(y, out)


def _const(e: ast.Expr):
    """Literal (possibly negated) argument value, else None."""
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.Unary) and e.op == "neg" \
            and isinstance(e.operand, ast.Literal):
        return -e.operand.value
    return None


def _column(t: pa.Table, name: str) -> pa.Array:
    a = t.column(name).combine_chunks()
    return a.dictionary_decode() if pa.types.is_dictionary(a.type) else a


def _dense_codes(a: pa.Array) -> Tuple[np.ndarray, np.ndarray, int]:
    """(codes, is-null, k): the non-null values' dense ranks 0..k-1 in
    value order; a NULL takes code k."""
    isnull = np.asarray(a.is_null().to_numpy(zero_copy_only=False), bool)
    if pa.types.is_null(a.type) or isnull.all():
        return np.zeros(len(a), np.int64), isnull, 0
    c = pc.rank(a, sort_keys="ascending", tiebreaker="dense").to_numpy()
    c = c.astype(np.int64) - 1
    k = int(c[~isnull].max()) + 1
    c[isnull] = k
    return c, isnull, k


def _order_codes(a: pa.Array, desc: bool, nulls_first) -> np.ndarray:
    """Ordering codes: value order, negated for DESC; NULLs last for ASC
    and first for DESC unless stated."""
    c, isnull, k = _dense_codes(a)
    if desc:
        c = -c
    nf = nulls_first if nulls_first is not None else desc
    c[isnull] = -(k + 1) if nf else (k + 1)
    return c


def _boundaries(keys: List[np.ndarray], n: int) -> np.ndarray:
    new = np.zeros(n, dtype=bool)
    if n:
        new[0] = True
    for c in keys:
        new[1:] |= c[1:] != c[:-1]
    return new


def _starts(new: np.ndarray) -> np.ndarray:
    pos = np.arange(len(new))
    return np.maximum.accumulate(np.where(new, pos, 0))


def _ends(new: np.ndarray) -> np.ndarray:
    n = len(new)
    pos = np.arange(n)
    is_last = np.empty(n, dtype=bool)
    if n:
        is_last[:-1] = new[1:]
        is_last[-1] = True
    endpos = np.where(is_last, pos, n)
    return np.minimum.accumulate(endpos[::-1])[::-1]


def _frame_kind(wf: ast.WindowFunc) -> Tuple[str, object, object]:
    """-> (unit, lo, hi) with lo/hi in {'unbounded', int offset} where
    negative = preceding; defaults applied."""
    if wf.frame is None:
        if wf.order_exprs:
            return ("range", "unbounded", 0)
        return ("rows", "unbounded", "unbounded")

    def bound(b: str):
        if b == "unbounded_preceding" or b == "unbounded_following":
            return "unbounded"
        if b == "current_row":
            return 0
        k, which = b.rsplit("_", 1)
        return -int(k) if which == "preceding" else int(k)

    unit, s, e = wf.frame
    if s == "unbounded_following" or e == "unbounded_preceding":
        raise ValueError(f"invalid frame {wf.frame}")
    return (unit, bound(s), bound(e))


def _seg_scan(x: np.ndarray, starts: np.ndarray, op) -> np.ndarray:
    """Inclusive scan of `op` restarting at each partition start, in
    log2(longest partition) vectorized passes (a float sum adds in a
    tree, with no cancellation against earlier partitions)."""
    n = len(x)
    if not n:
        return x.copy()
    pos = np.arange(n)
    longest = int((pos - starts).max()) + 1
    d = 1
    while d < longest:
        src = pos[d:] - d
        m = src >= starts[d:]
        y = x.copy()
        tgt = np.flatnonzero(m) + d
        y[tgt] = op(x[tgt], x[tgt - d])
        x = y
        d *= 2
    return x


def _range_reduce(c: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  op) -> np.ndarray:
    """op over c[lo[i]..hi[i]] for every i (each lo <= hi): a sparse
    table built one level at a time, each row answered at the level of
    its window's length."""
    out = np.empty(len(lo), dtype=c.dtype)
    if not len(lo):
        return out
    length = hi - lo + 1
    lvl = np.zeros(len(lo), np.int64)
    j = 1
    while (1 << j) <= int(length.max()):
        lvl[length >= (1 << j)] = j
        j += 1
    level = c
    for j in range(int(lvl.max()) + 1):
        sel = np.flatnonzero(lvl == j)
        out[sel] = op(level[lo[sel]], level[hi[sel] - (1 << j) + 1])
        half = 1 << j
        nxt = level.copy()
        nxt[:-half] = op(level[:-half], level[half:])
        level = nxt
    return out


def _range_values(a: pa.Array) -> np.ndarray:
    """The order key's values on a numeric axis for a RANGE offset frame
    (a date in days)."""
    if pa.types.is_date(a.type):
        a = a.cast(pa.date32()).cast(pa.int32())
    return np.asarray(a.cast(pa.float64()).to_numpy(zero_copy_only=False))


def _numeric(a: pa.Array, name: str):
    """(values with NULLs as 0, the type a sum returns): integers sum
    exactly in int64, floats in float64 returned in their own type,
    decimals in float64 (as the reference)."""
    t = a.type
    if pa.types.is_integer(t) or pa.types.is_boolean(t):
        x = pc.fill_null(a.cast(pa.int64()), 0)
        out_t = pa.int64()
    elif pa.types.is_floating(t) or pa.types.is_decimal(t) \
            or pa.types.is_null(t):
        x = pc.fill_null(a.cast(pa.float64()), 0.0)
        out_t = t if pa.types.is_floating(t) else pa.float64()
    else:
        raise NotImplementedError(f"window {name} over {t}")
    return np.asarray(x.to_numpy(zero_copy_only=False)), out_t


def _result_type(name: str, t: pa.DataType) -> pa.DataType:
    if name in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return pa.int64()
    if name == "avg":
        return pa.float64()
    if name == "sum":
        return _numeric(pa.array([], t), name)[1]
    return t


def _default_like(default, t: pa.DataType) -> pa.Scalar:
    try:
        return pa.scalar(default).cast(t)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError):
        raise NotImplementedError(
            f"lag/lead default {default!r} over {t}") from None


def compute_window(t: pa.Table, wf: ast.WindowFunc,
                   arg_names: List[str], part_names: List[str],
                   order_names: List[str]) -> pa.Array:
    """One window function's column, in the table's row order."""
    name = wf.func.name
    if name not in WINDOW_FUNCS:
        raise NotImplementedError(f"window function {name}")
    n = t.num_rows
    star = name == "count" and (wf.func.star or not arg_names)
    arg = _column(t, arg_names[0]) if arg_names and not star else None
    if arg is None and name not in ("row_number", "rank", "dense_rank",
                                    "ntile", "count"):
        raise NotImplementedError(f"window {name} over a constant")
    if n == 0:
        return pa.array([], _result_type(
            name, arg.type if arg is not None else pa.int64()))

    pcodes = [_dense_codes(_column(t, p))[0] for p in part_names]
    ocodes = [_order_codes(_column(t, o), d, nf) for o, d, nf in
              zip(order_names, wf.order_desc, wf.order_nulls_first)]
    keys = pcodes + ocodes
    sidx = np.lexsort(tuple(reversed(keys))) if keys else np.arange(n)
    new_part = _boundaries([c[sidx] for c in pcodes], n)
    new_peer = _boundaries([c[sidx] for c in keys], n)
    starts = _starts(new_part)
    ends = _ends(new_part)
    pos = np.arange(n)

    def scatter(res: np.ndarray) -> np.ndarray:
        out = np.empty(n, dtype=res.dtype)
        out[sidx] = res
        return out

    def ints(res: np.ndarray) -> pa.Array:
        return pa.array(scatter(res.astype(np.int64)), pa.int64())

    def gather(src: np.ndarray, valid: np.ndarray) -> pa.Array:
        """The argument at sorted positions `src`, NULL where not valid."""
        idx = scatter(sidx[np.clip(src, 0, n - 1)])
        return arg.take(pa.array(idx, mask=~scatter(valid)))

    # -- ranking -------------------------------------------------------
    if name == "row_number":
        return ints(pos - starts + 1)
    if name == "rank":
        return ints(_starts(new_peer) - starts + 1)
    if name == "dense_rank":
        dr = np.cumsum(new_peer)
        return ints(dr - dr[starts] + 1)
    if name == "ntile":
        k = int(_const(wf.func.args[0]))
        size = ends - starts + 1
        r = pos - starts
        q, rm = size // k, size % k
        big = rm * (q + 1)
        return ints(np.where(r < big, r // np.maximum(q + 1, 1),
                             rm + (r - big) // np.maximum(q, 1)) + 1)

    if name in ("lag", "lead"):
        args = wf.func.args
        off = int(_const(args[1])) if len(args) > 1 else 1
        default = _const(args[2]) if len(args) > 2 else None
        src = pos - off if name == "lag" else pos + off
        valid = (src >= starts) & (src <= ends)
        out = gather(src, valid)
        if default is None:
            return out
        return pc.if_else(pa.array(scatter(valid)), out,
                          _default_like(default, arg.type))

    # -- the frame of every row, [lo_i, hi_i] in sorted positions --------
    unit, lo, hi = _frame_kind(wf)
    peer_starts, peer_ends = _starts(new_peer), _ends(new_peer)
    ov = None
    if unit == "range" and any(isinstance(b, int) and b != 0
                               for b in (lo, hi)):
        # a RANGE offset frame: rows whose one order key lies within the
        # offsets of the current row's; DESC negates the value axis so
        # 'preceding' (larger values) is the same interval arithmetic
        if len(order_names) != 1:
            raise ValueError("RANGE offset frame requires ONE order key")
        oa = _column(t, order_names[0])
        if oa.null_count:
            raise NotImplementedError(
                "RANGE offset frame over NULL order key")
        ov = _range_values(oa)[sidx]
        if wf.order_desc[0]:
            ov = -ov

    def frame_end(b, side: str) -> np.ndarray:
        if b == "unbounded":
            return starts if side == "left" else ends
        if unit == "rows":
            return np.clip(pos + b, starts, ends)
        if b == 0:
            return peer_starts if side == "left" else peer_ends
        out = np.empty(n, np.int64)
        pstarts = np.flatnonzero(new_part)
        for s, e in zip(pstarts, np.append(pstarts[1:], n)):
            seg = ov[s:e]
            out[s:e] = s + np.searchsorted(seg, seg + float(b), side=side)
        return out if side == "left" else out - 1

    lo_i = frame_end(lo, "left")
    hi_i = frame_end(hi, "right")
    if unit == "rows":
        # an offset past the partition's edge leaves the frame empty
        if isinstance(lo, int):
            lo_i = np.where(pos + lo > ends, ends + 1, lo_i)
        if isinstance(hi, int):
            hi_i = np.where(pos + hi < starts, starts - 1, hi_i)
    valid = lo_i <= hi_i

    if name == "first_value":
        return gather(lo_i, valid)
    if name == "last_value":
        return gather(hi_i, valid)

    # -- framed aggregates ----------------------------------------------
    if star:
        nn = np.ones(n, dtype=bool)
    else:
        nn = ~np.asarray(arg.is_null().to_numpy(zero_copy_only=False),
                         bool)[sidx]
    cnn = np.cumsum(nn, dtype=np.int64)
    loc = np.clip(lo_i, 0, n - 1)
    hic = np.clip(hi_i, 0, n - 1)
    cnt = np.where(valid, cnn[hic] - np.where(lo_i > 0, cnn[loc - 1], 0),
                   0)
    if name == "count":
        return ints(cnt)
    empty = scatter(cnt == 0)

    if name in ("sum", "avg"):
        x, out_t = _numeric(arg, name)
        x = x[sidx]
        csum = _seg_scan(x, starts, np.add)
        zero = x.dtype.type(0)
        base = np.where(lo_i > starts, csum[np.maximum(loc - 1, 0)], zero)
        s = np.where(valid, csum[hic] - base, zero)
        if name == "avg":
            s = s / np.maximum(cnt, 1)
            out_t = pa.float64()
        return pa.array(scatter(s), mask=empty).cast(out_t)

    # min / max over the values' dense codes: a NULL never wins
    codes, isnull, k = _dense_codes(arg)
    rep = np.zeros(k + 1, np.int64)       # an input row of every code
    rep[codes[~isnull]] = np.flatnonzero(~isnull)
    op = np.minimum if name == "min" else np.maximum
    codes = np.where(isnull, k + 1 if name == "min" else -1, codes)[sidx]
    win = np.flatnonzero(valid)
    best = np.zeros(n, np.int64)
    best[win] = _range_reduce(codes, lo_i[win], hi_i[win], op)
    idx = rep[np.clip(scatter(best), 0, k)]
    return arg.take(pa.array(idx, mask=empty))
