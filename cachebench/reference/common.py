"""What the plain reference answers share: the reader of the generated
parquet files and pyarrow helpers (copied from
`liquid_tpu_torch/bench/oracle.py` and frozen here).

Each query's reference is `reference/<config>/<query>.py`: a function
`answer(db) -> [pa.Array, ...]` (the answer's columns in the query's
select order) and, where a LIMIT may cut through rows tied on the ORDER BY
keys, `CUT = (positions of the order keys, OFFSET, LIMIT)`; such a query's
`answer` returns every row through the cut's ties, in order.
"""
from __future__ import annotations

import datetime
from typing import Dict, List

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

EVERY = pc.CountOptions(mode="all")


class Tables:
    """The generated tables by name.  `float_type` float32 reads every
    float64 column as float32: the control, the reference one precision
    below the configuration's."""

    def __init__(self, paths: Dict[str, str], float_type=pa.float64()):
        self.paths = paths
        self.float_type = float_type

    def read(self, table: str, columns: List[str]) -> pa.Table:
        t = pq.read_table(self.paths[table], columns=columns)
        if self.float_type == pa.float64():
            return t
        return pa.table([c.cast(self.float_type)
                         if pa.types.is_float64(c.type) else c
                         for c in t.columns], names=t.column_names)

    def num_rows(self, table: str) -> int:
        return pq.read_metadata(self.paths[table]).num_rows


def date(*ymd) -> pa.Scalar:
    return pa.scalar(datetime.date(*ymd))


def join(left: pa.Table, right: pa.Table, lkey: str, rkey: str) -> pa.Table:
    return left.join(right, lkey, rkey, join_type="inner")


def revenue(t: pa.Table) -> pa.Array:
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(1.0, t["l_discount"]))


def between(a, lo, hi):
    return pc.and_(pc.greater_equal(a, lo), pc.less_equal(a, hi))


def sort(t: pa.Table, keys) -> pa.Table:
    return t.take(pc.sort_indices(t, sort_keys=keys))


def nations(db: Tables, prefix: str) -> pa.Table:
    n = db.read("nation", ["n_nationkey", "n_name", "n_regionkey"])
    return n.rename_columns([prefix + c for c in n.column_names])


def top_ties(g: pa.Table, col: str, k: int) -> pa.Table:
    """`g` by `col` descending, cut after the rows tied with the k-th."""
    g = g.sort_by([(col, "descending")])
    if g.num_rows <= k:
        return g
    kth = g[col][k - 1].as_py()
    return g.filter(pc.greater_equal(g[col], kth))


def counts(db: Tables, keys, nonempty_phrase: bool, k: int,
           extra=()) -> List[pa.Array]:
    """hits GROUP BY keys with COUNT(*) AS c (and `extra` aggregates)
    ORDER BY c DESC LIMIT k: the rows through the cut's ties."""
    cols = list(dict.fromkeys(list(keys) + [c for c, _f in extra]
                              + (["SearchPhrase"] if nonempty_phrase
                                 else [])))
    h = db.read("hits", cols)
    if nonempty_phrase:
        h = h.filter(pc.not_equal(h["SearchPhrase"], ""))
    g = h.group_by(list(keys)).aggregate(
        [(keys[0], "count", EVERY)] + list(extra))
    g = top_ties(g, f"{keys[0]}_count", k)
    return [g[c] for c in keys] + [g[f"{keys[0]}_count"]] + [
        g[f"{c}_{f}"] for c, f in extra]


def distinct_users(t: pa.Table, keys: List[str]) -> List[pa.Array]:
    """COUNT(DISTINCT UserID) by `keys`, descending."""
    g = t.group_by(keys).aggregate([
        ("UserID", "count_distinct", pc.CountOptions(mode="only_valid"))
    ]).sort_by([("UserID_count_distinct", "descending")])
    return [g[k] for k in keys] + [g["UserID_count_distinct"]]


def wide(db: Tables, keys, nonempty_phrase: bool) -> List[pa.Array]:
    """COUNT(*) AS c, SUM(IsRefresh), AVG(ResolutionWidth) by two keys,
    ORDER BY c DESC LIMIT 10."""
    return counts(db, keys, nonempty_phrase, 10,
                  [("IsRefresh", "sum"), ("ResolutionWidth", "mean")])
