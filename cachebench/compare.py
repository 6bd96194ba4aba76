"""The comparison that decides `correct`: an answer of the program against
the plain reference's columns (copied from the correctness gate of
`liquid_tpu_torch/bench/oracle.py`, with the float tolerance a parameter,
and frozen here).

`agrees`: non-float cells exactly equal, float cells within a relative
`rtol`; where the reference names a `CUT` (a LIMIT that may cut through
rows tied on the ORDER BY keys), the tie rule: the order keys equal
position by position, the rows not tied at a cut equal as multisets, and
each tied row one of the reference's rows with that key (SQL leaves the
pick among them open).

`float_gap`: the widest relative gap of a float cell, each row of the
answer held to the reference's rows that have the same non-float cells.

Both read only the reference rows that can match a row of the answer
(`_candidates`), so a cut through millions of tied groups costs no more
than the groups' columns take to scan.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


def _cell_key(v):
    """A hashable, sortable form of a cell: floats to 9 significant
    digits, NULL first, NaN last."""
    if isinstance(v, float) and v != v:
        return (2,)
    if isinstance(v, float):
        return (1, float(f"{v:.9g}"))
    return (0,) if v is None else (1, v)


def _rows(cols) -> List[tuple]:
    return list(zip(*[c.to_pylist() for c in cols]))


def _is_float(col) -> bool:
    return pa.types.is_floating(col.type)


def _candidates(want: List[pa.Array], rows: List[tuple], skip=()
                ) -> List[tuple]:
    """The reference rows whose every non-float cell (columns not in
    `skip`) is one that `rows` hold in that column: a superset of the rows
    that can match one of `rows`, which the caller judges row by row."""
    if not want:
        return []
    mask = None
    for i, col in enumerate(want):
        if i in skip or _is_float(col):
            continue
        try:
            vals = pa.array([r[i] for r in rows], type=col.type)
        except (pa.ArrowException, TypeError, OverflowError):
            continue  # no cell of `rows` is of the column's type
        hit = pc.is_in(col, value_set=vals)
        mask = hit if mask is None else pc.and_(mask, hit)
    table = pa.table({f"c{i}": c for i, c in enumerate(want)})
    return _rows((table if mask is None else table.filter(mask)).columns)


def _close_row(a, b, rtol: float) -> bool:
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not (x == y or (x != x and y != y)
                    or abs(x - y) <= rtol * max(abs(x), abs(y))):
                return False
        elif x != y:
            return False
    return True


def _same_rows(a: List[tuple], b: List[tuple], rtol: float) -> bool:
    """Equal as multisets under `_close_row`: both sorted, the non-float
    cells first, then compared pairwise."""
    if len(a) != len(b):
        return False
    fcols = {i for r in a + b for i, v in enumerate(r)
             if isinstance(v, float)}

    def order(r):
        return (tuple(_cell_key(v) for i, v in enumerate(r)
                      if i not in fcols)
                + tuple((0,) if v is None else (2,) if v != v else (1, v)
                        for i, v in enumerate(r) if i in fcols))
    return all(_close_row(x, y, rtol) for x, y in
               zip(sorted(a, key=order), sorted(b, key=order)))


def _same_cut(out: pa.Table, want: List[pa.Array], cut, rtol: float
              ) -> bool:
    keys, offset, limit = cut
    n = len(want[0]) if want else 0
    lo, hi = min(offset, n), min(offset + limit, n)
    got = _rows(out.columns)
    if out.num_columns != len(want) or len(got) != hi - lo:
        return False
    if not got:
        return True
    part = _rows([c.slice(lo, hi - lo) for c in want])

    def key(r):
        return tuple(_cell_key(r[i]) for i in keys)

    if [key(r) for r in got] != [key(r) for r in part]:
        return False
    tied = {key(part[-1])} | ({key(part[0])} if lo else set())
    if not _same_rows([r for r in got if key(r) not in tied],
                      [r for r in part if key(r) not in tied], rtol):
        return False
    mine = [r for r in got if key(r) in tied]
    floats = {i for i, c in enumerate(out.columns) if _is_float(c)}
    pool = [r for r in _candidates(want, mine, floats) if key(r) in tied]
    if not any(isinstance(v, float) for r in mine for v in r):
        left = Counter(pool)
        for r in mine:
            if left[r] <= 0:
                return False
            left[r] -= 1
        return True
    for r in mine:
        hit = next((i for i, w in enumerate(pool)
                    if _close_row(r, w, rtol)), None)
        if hit is None:
            return False
        pool.pop(hit)
    return True


def agrees(out: pa.Table, want: List[pa.Array], cut: Optional[tuple],
           rtol: float) -> bool:
    """The answer `out` agrees with the reference columns `want`."""
    if cut is not None:
        return _same_cut(out, want, cut, rtol)
    if out.num_columns != len(want) or out.num_rows != len(want[0]):
        return False
    for got, exp in zip(out.columns, want):
        if pa.types.is_floating(got.type) or pa.types.is_floating(exp.type):
            a = np.asarray(got.to_numpy(zero_copy_only=False), float)
            b = np.asarray(exp.to_numpy(zero_copy_only=False), float)
            if not np.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True):
                return False
        elif got.to_pylist() != exp.to_pylist():
            return False
    return True


def _rel(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is b else math.inf
    if a != a or b != b:
        return 0.0 if (a != a and b != b) else math.inf
    scale = max(abs(a), abs(b))
    return abs(a - b) / scale if scale else 0.0


def float_gap(out: pa.Table, want: List[pa.Array]) -> float:
    """The widest relative gap of a float cell of `out` from the
    reference row with the same non-float cells that lies nearest; rows
    with no such reference row are `agrees`'s to judge."""
    if out.num_columns != len(want):
        return 0.0
    fcols = [i for i, (g, w) in enumerate(zip(out.columns, want))
             if _is_float(g) or _is_float(w)]
    if not fcols:
        return 0.0
    fset = set(fcols)

    def sig(r):
        return tuple(v for i, v in enumerate(r) if i not in fset)

    got = _rows(out.columns)
    by_sig = defaultdict(list)
    for r in _candidates(want, got, fset):
        by_sig[sig(r)].append(r)
    worst = 0.0
    for r in got:
        cands = by_sig.get(sig(r))
        if cands:
            worst = max(worst, min(
                max(_rel(float(r[i]) if r[i] is not None else None, c[i])
                    for i in fcols) for c in cands))
    return worst
