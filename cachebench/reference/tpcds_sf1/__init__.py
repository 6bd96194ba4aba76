"""What the TPC-DS references share: ORDER BY with NULLs placed, ROLLUP as
one group-by per key prefix, the runs of a sorted key, the date windows
and dimension filters the queries repeat, and the parts that several
queries have in common (q12 / q20 / q98, q36 / q86, q38 / q87).  The
order, rollup, rank and running-window code is copied from the TPC-DS
oracles of `liquid_tpu_torch/bench/oracle.py` and frozen here."""
from __future__ import annotations

import datetime
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import between, join


def order(t: pa.Table, keys) -> pa.Table:
    """`t` sorted by (column, descending, nulls first) keys."""
    cols, sort_keys = {}, []
    for i, (k, desc, nulls_first) in enumerate(keys):
        isnull = pc.is_null(t[k])
        cols[f"n{i}"] = pc.invert(isnull) if nulls_first else isnull
        cols[f"k{i}"] = t[k]
        sort_keys += [(f"n{i}", "ascending"),
                      (f"k{i}", "descending" if desc else "ascending")]
    return t.take(pc.sort_indices(pa.table(cols), sort_keys=sort_keys))


def segments(keys: np.ndarray):
    """(start, end) of each run of equal values in a sorted key array."""
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) \
        if len(keys) else np.zeros(0, np.int64)
    return zip(starts, np.r_[starts[1:], len(keys)])


def run_ids(t: pa.Table, keys: List[str]) -> np.ndarray:
    """For `t` sorted by `keys`: the number of the run of equal keys each
    row is in."""
    n = t.num_rows
    new = np.zeros(n, bool)
    if n:
        new[0] = True
    for k in keys:
        a = t[k].combine_chunks()
        if n > 1:
            ne = pc.fill_null(pc.not_equal(a.slice(1), a.slice(0, n - 1)),
                              True)
            both_null = pc.and_(pc.is_null(a.slice(1)),
                                pc.is_null(a.slice(0, n - 1)))
            ne = pc.and_(ne, pc.invert(both_null))
            new[1:] |= ne.to_numpy(zero_copy_only=False)
    return np.cumsum(new) - 1


def rollup(j: pa.Table, keys: List[str], aggs) -> pa.Table:
    """ROLLUP(keys): one grouping per key prefix, longest first, the keys
    left out NULL, and `__level` the number left out.  `aggs` are
    (column, function) pairs, named `<column>_<function>`."""
    parts = []
    names = [f"{c}_{f}" for c, f in aggs]
    for i in range(len(keys), -1, -1):
        if i:
            g = j.group_by(keys[:i], use_threads=False).aggregate(aggs)
            g = g.select(names + keys[:i])
        else:
            g = pa.table({n: pa.array([getattr(pc, f)(j[c]).as_py()],
                                      j.schema.field(c).type
                                      if f == "sum" else pa.float64())
                          for n, (c, f) in zip(names, aggs)})
        for k in keys[i:]:
            g = g.append_column(k, pa.nulls(g.num_rows,
                                             j.schema.field(k).type))
        g = g.append_column("__level", pa.array(
            [len(keys) - i] * g.num_rows, pa.int64()))
        parts.append(g.select(keys + names + ["__level"]))
    return pa.concat_tables(parts, promote_options="permissive")


def days(y: int, m: int, d: int, after: int):
    """The dates from y-m-d through `after` days later."""
    lo = datetime.date(y, m, d)
    return pa.scalar(lo), pa.scalar(lo + datetime.timedelta(days=after))


def date_sks(db, lo, hi) -> pa.Table:
    """date_dim's keys of the dates in [lo, hi]."""
    d = db.read("date_dim", ["d_date_sk", "d_date"])
    return d.filter(between(d["d_date"], lo, hi)).select(["d_date_sk"])


def month_seq(db, lo: int, hi: int, cols=()) -> pa.Table:
    """date_dim's keys (and `cols`) of the months lo..hi (d_month_seq)."""
    d = db.read("date_dim", ["d_date_sk", "d_month_seq", *cols])
    return d.filter(between(d["d_month_seq"], lo, hi)).select(
        ["d_date_sk", *cols])


def year_moy(db, year: int, moy: int = None, cols=()) -> pa.Table:
    """date_dim's keys (and `cols`) of one year, or one month of it."""
    d = db.read("date_dim", ["d_date_sk", "d_year", "d_moy", *cols])
    m = pc.equal(d["d_year"], year)
    if moy is not None:
        m = pc.and_(m, pc.equal(d["d_moy"], moy))
    return d.filter(m).select(["d_date_sk", *cols])


def semi(t: pa.Table, key: str, keys: pa.Table, dkey: str) -> pa.Table:
    """The rows of `t` whose `key` is one of `keys[dkey]`."""
    return t.filter(pc.is_in(t[key], value_set=keys[dkey]))


def item_revenue(db, fact: str, pfx: str) -> pa.Table:
    """q12, q20, q98: each Sports, Books or Home item's revenue in a
    channel over 1999-02-22 and the 30 days after, and its share of its
    class's revenue (sum(sum(x)) OVER (PARTITION BY i_class)), ordered by
    i_category, i_class, i_item_id, i_item_desc, revenueratio."""
    it = db.read("item", ["i_item_sk", "i_item_id", "i_item_desc",
                          "i_category", "i_class", "i_current_price"])
    it = it.filter(pc.is_in(it["i_category"], value_set=pa.array(
        ["Sports", "Books", "Home"])))
    f = db.read(fact, [f"{pfx}_item_sk", f"{pfx}_sold_date_sk",
                       f"{pfx}_ext_sales_price"])
    j = join(join(f, it, f"{pfx}_item_sk", "i_item_sk"),
             date_sks(db, *days(1999, 2, 22, 30)), f"{pfx}_sold_date_sk",
             "d_date_sk")
    keys = ["i_item_id", "i_item_desc", "i_category", "i_class",
            "i_current_price"]
    g = j.group_by(keys, use_threads=False).aggregate(
        [(f"{pfx}_ext_sales_price", "sum")]).select(
        keys + [f"{pfx}_ext_sales_price_sum"]).rename_columns(
        keys + ["itemrevenue"])
    cls = g.group_by("i_class", use_threads=False).aggregate(
        [("itemrevenue", "sum")])
    g = g.join(cls, "i_class")
    g = g.append_column("revenueratio", pc.divide(
        pc.multiply(g["itemrevenue"], 100), g["itemrevenue_sum"]))
    return order(g, [(k, False, False) for k in
                     ("i_category", "i_class", "i_item_id", "i_item_desc",
                      "revenueratio")])


def item_revenue_columns(g: pa.Table) -> List[pa.Array]:
    return [g[c] for c in ("i_item_id", "i_item_desc", "i_category",
                           "i_class", "i_current_price", "itemrevenue",
                           "revenueratio")]


def rank_in_parent(g: pa.Table, value: str, desc: bool) -> pa.Table:
    """q36, q86 over a ROLLUP(i_category, i_class): rank() OVER (PARTITION
    BY the level, the category at level 0 ORDER BY `value`), then ORDER BY
    level desc, that category nulls first, the rank; `__parent` is the
    partition's category (NULL above level 0)."""
    level = g["__level"].to_numpy()
    parent = np.where(level == 0, g["i_category"].to_numpy(
        zero_copy_only=False), None)
    v = g[value].to_numpy(zero_copy_only=False).astype(np.float64)
    rank = np.zeros(g.num_rows, np.int64)
    groups = {}
    for i, key in enumerate(zip(level.tolist(), parent.tolist())):
        groups.setdefault(key, []).append(i)
    for rows in groups.values():
        x = v[rows]
        ahead = (x[None, :] > x[:, None]) if desc else \
            (x[None, :] < x[:, None])
        rank[rows] = 1 + ahead.sum(axis=1)
    g = g.append_column("rank_within_parent", pa.array(rank)) \
        .append_column("__parent", pa.array(parent.tolist(), pa.string()))
    return order(g, [("__level", True, True), ("__parent", False, True),
                     ("rank_within_parent", False, False)])


def names_by_day(db, fact: str, pfx: str) -> pa.Table:
    """q38, q87: the distinct (c_last_name, c_first_name, d_date) of a
    channel's sales in 2000 (d_month_seq 24-35)."""
    d = month_seq(db, 24, 35, ["d_date"])
    f = semi(db.read(fact, [f"{pfx}_sold_date_sk", f"{pfx}_customer_sk"]),
             f"{pfx}_sold_date_sk", d, "d_date_sk")
    j = join(join(f, d, f"{pfx}_sold_date_sk", "d_date_sk"),
             db.read("customer", ["c_customer_sk", "c_last_name",
                                  "c_first_name"]),
             f"{pfx}_customer_sk", "c_customer_sk")
    return j.group_by(["c_last_name", "c_first_name", "d_date"],
                      use_threads=False).aggregate([]).select(
        ["c_last_name", "c_first_name", "d_date"])


def channels_names_by_day(db) -> List[pa.Table]:
    return [names_by_day(db, f, p) for f, p in (
        ("store_sales", "ss"), ("catalog_sales", "cs"), ("web_sales", "ws"))]
