"""Independent answers for the port's benchmark and smoke queries.

Each query is computed by pyarrow compute (filters, `Table.join`,
`group_by`, sorts) straight from the same parquet files the engine reads,
never through the engine, as a list of columns in the query's select
order.  `same_table`
is the reference bench's correctness gate (`bench.py`): non-float columns
must be exactly equal, float columns equal to rtol 1e-9.  Names that
`answers` does not know raise KeyError.
"""
from __future__ import annotations

import datetime
from typing import Dict, Iterable, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

_EVERY = pc.CountOptions(mode="all")


def _date(*ymd) -> pa.Scalar:
    return pa.scalar(datetime.date(*ymd))


def _cb_filter(paths) -> List[pa.Array]:
    adv = pq.read_table(paths["hits"], columns=["AdvEngineID"])["AdvEngineID"]
    return [pa.array([pc.sum(pc.not_equal(adv, 0)).as_py()], pa.int64())]


def _cb_like(paths) -> List[pa.Array]:
    url = pq.read_table(paths["hits"], columns=["URL"])["URL"]
    hits = pc.sum(pc.match_like(url, "%yandex%")).as_py() or 0
    return [pa.array([hits], pa.int64())]


def _tpch_q6(paths) -> List[pa.Array]:
    li = pq.read_table(paths["lineitem"], columns=[
        "l_extendedprice", "l_discount", "l_shipdate", "l_quantity"])
    m = pc.and_(
        pc.and_(pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
                pc.less(li["l_shipdate"], _date(1995, 1, 1))),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.05),
                        pc.less_equal(li["l_discount"], 0.07)),
                pc.less(li["l_quantity"], 24)))
    f = li.filter(m)
    rev = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"])).as_py()
    return [pa.array([rev], pa.float64())]


def _cb_groupby(paths) -> List[pa.Array]:
    hits = pq.read_table(paths["hits"], columns=[
        "RegionID", "AdvEngineID", "ResolutionWidth"])
    g = hits.group_by("RegionID").aggregate([
        ("AdvEngineID", "sum"), ("AdvEngineID", "count", _EVERY),
        ("ResolutionWidth", "mean")]).sort_by([
            ("AdvEngineID_count", "descending"),
            ("RegionID", "ascending")]).slice(0, 10)
    return [g["RegionID"], g["AdvEngineID_sum"], g["AdvEngineID_count"],
            g["ResolutionWidth_mean"]]


def _cb_q15(paths) -> List[pa.Array]:
    hits = pq.read_table(paths["hits"], columns=["UserID"])
    u = hits.group_by("UserID").aggregate([
        ("UserID", "count", _EVERY)]).sort_by([
            ("UserID_count", "descending"), ("UserID", "ascending")]
    ).slice(0, 10)
    return [u["UserID"], u["UserID_count"]]


def _tpch_q15_revenue(paths) -> List[pa.Array]:
    li = pq.read_table(paths["lineitem"], columns=[
        "l_suppkey", "l_extendedprice", "l_discount", "l_shipdate"])
    f = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1996, 1, 1)),
        pc.less(li["l_shipdate"], _date(1996, 4, 1))))
    rev = pc.multiply(f["l_extendedprice"], pc.subtract(1.0, f["l_discount"]))
    r = pa.table({"l_suppkey": f["l_suppkey"], "rev": rev}).group_by(
        "l_suppkey").aggregate([("rev", "sum")]).sort_by("l_suppkey")
    return [r["l_suppkey"], r["rev_sum"]]


def _tpch_supp_price(paths) -> List[pa.Array]:
    li = pq.read_table(paths["lineitem"], columns=[
        "l_suppkey", "l_extendedprice", "l_shipdate"])
    f = li.filter(pc.less_equal(li["l_shipdate"], _date(1998, 9, 2)))
    b = f.group_by("l_suppkey").aggregate([
        ("l_extendedprice", "sum"),
        ("l_suppkey", "count", _EVERY)]).sort_by("l_suppkey")
    return [b["l_suppkey"], b["l_extendedprice_sum"], b["l_suppkey_count"]]


def _tpch_q1(paths) -> List[pa.Array]:
    li = pq.read_table(paths["lineitem"], columns=[
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate"])
    f = li.filter(pc.less_equal(li["l_shipdate"], _date(1998, 9, 2)))
    disc = pc.multiply(f["l_extendedprice"], pc.subtract(1.0, f["l_discount"]))
    t = pa.table({
        "rf": f["l_returnflag"], "ls": f["l_linestatus"],
        "qty": f["l_quantity"], "price": f["l_extendedprice"],
        "disc_price": disc, "charge": pc.multiply(disc,
                                                  pc.add(1.0, f["l_tax"])),
        "disc": f["l_discount"]})
    g = t.group_by(["rf", "ls"]).aggregate([
        ("qty", "sum"), ("price", "sum"), ("disc_price", "sum"),
        ("charge", "sum"), ("qty", "mean"), ("price", "mean"),
        ("disc", "mean"), ("qty", "count", _EVERY)]).sort_by([
            ("rf", "ascending"), ("ls", "ascending")])
    return [g["rf"], g["ls"], g["qty_sum"], g["price_sum"],
            g["disc_price_sum"], g["charge_sum"], g["qty_mean"],
            g["price_mean"], g["disc_mean"], g["qty_count"]]


def _read(paths, table, cols) -> pa.Table:
    return pq.read_table(paths[table], columns=cols)


def _join(left: pa.Table, right: pa.Table, lkey: str, rkey: str
          ) -> pa.Table:
    return left.join(right, lkey, rkey, join_type="inner")


def _revenue(t: pa.Table) -> pa.Array:
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(1.0, t["l_discount"]))


def _tpch_q3(paths) -> List[pa.Array]:
    """The bench's q3 (ties broken by l_orderkey), by `Table.join`."""
    c = _read(paths, "customer", ["c_custkey", "c_mktsegment"])
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING"))
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_orderdate",
                                "o_shippriority"])
    o = o.filter(pc.less(o["o_orderdate"], _date(1995, 3, 15)))
    li = _read(paths, "lineitem", ["l_orderkey", "l_extendedprice",
                                   "l_discount", "l_shipdate"])
    li = li.filter(pc.greater(li["l_shipdate"], _date(1995, 3, 15)))
    oc = _join(o, c.select(["c_custkey"]), "o_custkey", "c_custkey")
    j = _join(li, oc, "l_orderkey", "o_orderkey")
    keys = ["l_orderkey", "o_orderdate", "o_shippriority"]
    t = pa.table({**{k: j[k] for k in keys}, "rev": _revenue(j)})
    g = t.group_by(keys).aggregate([("rev", "sum")]).sort_by([
        ("rev_sum", "descending"), ("o_orderdate", "ascending"),
        ("l_orderkey", "ascending")]).slice(0, 10)
    return [g["l_orderkey"], g["rev_sum"], g["o_orderdate"],
            g["o_shippriority"]]


def _tpch_q5(paths) -> List[pa.Array]:
    r = _read(paths, "region", ["r_regionkey", "r_name"])
    r = r.filter(pc.equal(r["r_name"], "ASIA"))
    n = _read(paths, "nation", ["n_nationkey", "n_name", "n_regionkey"])
    n = _join(n, r.select(["r_regionkey"]), "n_regionkey", "r_regionkey")
    s = _read(paths, "supplier", ["s_suppkey", "s_nationkey"])
    s = _join(s, n.select(["n_nationkey", "n_name"]), "s_nationkey",
              "n_nationkey")
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1994, 1, 1)),
        pc.less(o["o_orderdate"], _date(1995, 1, 1))))
    o = _join(o, _read(paths, "customer", ["c_custkey", "c_nationkey"]),
              "o_custkey", "c_custkey")
    li = _read(paths, "lineitem", ["l_orderkey", "l_suppkey",
                                   "l_extendedprice", "l_discount"])
    j = _join(_join(li, o.select(["o_orderkey", "c_nationkey"]),
                    "l_orderkey", "o_orderkey"), s, "l_suppkey", "s_suppkey")
    j = j.filter(pc.equal(j["c_nationkey"], j["s_nationkey"]))
    g = pa.table({"n_name": j["n_name"], "rev": _revenue(j)}).group_by(
        "n_name").aggregate([("rev", "sum")]).sort_by(
            [("rev_sum", "descending")])
    return [g["n_name"], g["rev_sum"]]


def _tpch_q10(paths) -> List[pa.Array]:
    """TPC-H q10 (ties broken by c_custkey)."""
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 10, 1)),
        pc.less(o["o_orderdate"], _date(1994, 1, 1))))
    li = _read(paths, "lineitem", ["l_orderkey", "l_extendedprice",
                                   "l_discount", "l_returnflag"])
    li = li.filter(pc.equal(li["l_returnflag"], "R"))
    c = _join(_read(paths, "customer", [
        "c_custkey", "c_name", "c_acctbal", "c_phone", "c_address",
        "c_comment", "c_nationkey"]), _read(paths, "nation", [
            "n_nationkey", "n_name"]), "c_nationkey", "n_nationkey")
    j = _join(_join(li, o.select(["o_orderkey", "o_custkey"]), "l_orderkey",
                    "o_orderkey"), c, "o_custkey", "c_custkey")
    keys = ["o_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
            "c_address", "c_comment"]
    t = pa.table({**{k: j[k] for k in keys}, "rev": _revenue(j)})
    g = t.group_by(keys).aggregate([("rev", "sum")]).sort_by([
        ("rev_sum", "descending"), ("o_custkey", "ascending")]).slice(0, 20)
    return [g["o_custkey"], g["c_name"], g["rev_sum"], g["c_acctbal"],
            g["n_name"], g["c_address"], g["c_phone"], g["c_comment"]]


ORACLES = {"cb_filter": _cb_filter, "cb_like": _cb_like,
           "tpch_q6": _tpch_q6, "cb_groupby": _cb_groupby,
           "cb_q15": _cb_q15, "tpch_q15_revenue": _tpch_q15_revenue,
           "tpch_supp_price": _tpch_supp_price, "tpch_q1": _tpch_q1,
           "tpch_q3": _tpch_q3, "tpch_q5": _tpch_q5, "tpch_q10": _tpch_q10}


def answers(paths: Dict[str, str], names: Iterable[str]
            ) -> Dict[str, List[pa.Array]]:
    """{query name: its columns} for the named queries."""
    return {n: ORACLES[n](paths) for n in names}


def same_table(out: pa.Table, want: List[pa.Array]) -> bool:
    """Engine result vs oracle columns: non-float columns exactly equal,
    float columns rtol 1e-9."""
    if out.num_columns != len(want) or out.num_rows != len(want[0]):
        return False
    for got, exp in zip(out.columns, want):
        if pa.types.is_floating(got.type):
            a = np.asarray(got.to_numpy(zero_copy_only=False), float)
            b = np.asarray(exp.to_numpy(zero_copy_only=False), float)
            if not np.allclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True):
                return False
        elif got.to_pylist() != exp.to_pylist():
            return False
    return True
