"""Independent answers for the port's benchmark and smoke queries.

Each query is computed by pyarrow compute (filters, `Table.join`,
`group_by`, sorts) straight from the same parquet files the engine reads,
never through the engine, as a list of columns in the query's select
order.  `same_table`
is the reference bench's correctness gate (`bench.py`): non-float columns
must be exactly equal, float columns equal to rtol 1e-9.  Names that
`answers` does not know raise KeyError.

A query whose LIMIT may cut through rows tied on its ORDER BY keys
(`CUTS`) has every row of its answer returned in order; `same_table`
then applies the tie rule: the port's order keys equal the oracle's at
the same positions, the rows not tied at a cut compare as multisets, and
each tied row must be one of the oracle's rows with that key (SQL leaves
the pick among them open).
"""
from __future__ import annotations

import datetime
from typing import Dict, Iterable, List, Optional, Tuple

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


def _tpch_q12(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_orderkey", "l_shipmode", "l_shipdate",
                                   "l_commitdate", "l_receiptdate"])
    li = li.filter(pc.and_(pc.and_(
        pc.is_in(li["l_shipmode"], pa.array(["MAIL", "SHIP"])),
        pc.and_(pc.less(li["l_commitdate"], li["l_receiptdate"]),
                pc.less(li["l_shipdate"], li["l_commitdate"]))), pc.and_(
        pc.greater_equal(li["l_receiptdate"], _date(1994, 1, 1)),
        pc.less(li["l_receiptdate"], _date(1995, 1, 1)))))
    j = _join(li, _read(paths, "orders", ["o_orderkey", "o_orderpriority"]),
              "l_orderkey", "o_orderkey")
    high = pc.is_in(j["o_orderpriority"], pa.array(["1-URGENT", "2-HIGH"]))
    t = pa.table({"mode": j["l_shipmode"],
                  "high": pc.cast(high, pa.int64()),
                  "low": pc.cast(pc.invert(high), pa.int64())})
    g = t.group_by("mode").aggregate([("high", "sum"), ("low", "sum")]
                                     ).sort_by("mode")
    return [g["mode"], g["high_sum"], g["low_sum"]]


def _tpch_q14(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_partkey", "l_extendedprice",
                                   "l_discount", "l_shipdate"])
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1995, 9, 1)),
        pc.less(li["l_shipdate"], _date(1995, 10, 1))))
    j = _join(li, _read(paths, "part", ["p_partkey", "p_type"]),
              "l_partkey", "p_partkey")
    rev = _revenue(j)
    promo = pc.sum(pc.if_else(pc.starts_with(j["p_type"], "PROMO"), rev,
                              0.0)).as_py()
    return [pa.array([100.0 * promo / pc.sum(rev).as_py()], pa.float64())]


def _tpch_q19(paths) -> List[pa.Array]:
    """q19: three (brand, containers, quantity range, size range) branches
    over the part-lineitem join, AIR shipments delivered in person."""
    li = _read(paths, "lineitem", ["l_partkey", "l_quantity",
                                   "l_extendedprice", "l_discount",
                                   "l_shipmode", "l_shipinstruct"])
    li = li.filter(pc.and_(
        pc.is_in(li["l_shipmode"], pa.array(["AIR", "AIR REG"])),
        pc.equal(li["l_shipinstruct"], "DELIVER IN PERSON")))
    j = _join(li, _read(paths, "part", ["p_partkey", "p_brand",
                                        "p_container", "p_size"]),
              "l_partkey", "p_partkey")
    keep = None
    for brand, size, qty, cont in (
            ("Brand#12", 5, 1, "SM"), ("Brand#23", 10, 10, "MED"),
            ("Brand#34", 15, 20, "LG")):
        kinds = ("CASE", "BOX", "PACK", "PKG") if cont != "MED" else (
            "BAG", "BOX", "PKG", "PACK")
        branch = pc.and_(pc.and_(
            pc.equal(j["p_brand"], brand),
            pc.is_in(j["p_container"],
                     pa.array([f"{cont} {k}" for k in kinds]))), pc.and_(
            _between(j["l_quantity"], qty, qty + 10),
            _between(j["p_size"], 1, size)))
        keep = branch if keep is None else pc.or_(keep, branch)
    return [pa.array([pc.sum(_revenue(j.filter(keep))).as_py()],
                     pa.float64())]


# -- TPC-H's multi-table queries (the star and existence-probe slice) ------

def _between(a, lo, hi):
    return pc.and_(pc.greater_equal(a, lo), pc.less_equal(a, hi))


def _sorted(t: pa.Table, keys) -> pa.Table:
    return t.take(pc.sort_indices(t, sort_keys=keys))


def _tpch_q4(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_orderkey", "l_commitdate",
                                   "l_receiptdate"])
    late = pc.unique(li.filter(pc.less(li["l_commitdate"],
                                       li["l_receiptdate"]))["l_orderkey"])
    o = _read(paths, "orders", ["o_orderkey", "o_orderdate",
                                "o_orderpriority"])
    o = o.filter(pc.and_(pc.and_(
        pc.greater_equal(o["o_orderdate"], _date(1993, 7, 1)),
        pc.less(o["o_orderdate"], _date(1993, 10, 1))),
        pc.is_in(o["o_orderkey"], value_set=late)))
    g = o.group_by("o_orderpriority").aggregate([
        ("o_orderkey", "count", _EVERY)]).sort_by("o_orderpriority")
    return [g["o_orderpriority"], g["o_orderkey_count"]]


def _nations(paths, prefix: str) -> pa.Table:
    n = _read(paths, "nation", ["n_nationkey", "n_name", "n_regionkey"])
    return n.rename_columns([prefix + c for c in n.column_names])


def _tpch_q7(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_orderkey", "l_suppkey", "l_shipdate",
                                   "l_extendedprice", "l_discount"])
    li = li.filter(_between(li["l_shipdate"], _date(1995, 1, 1),
                            _date(1996, 12, 31)))
    s = _join(_read(paths, "supplier", ["s_suppkey", "s_nationkey"]),
              _nations(paths, "n1_"), "s_nationkey", "n1_n_nationkey")
    c = _join(_read(paths, "customer", ["c_custkey", "c_nationkey"]),
              _nations(paths, "n2_"), "c_nationkey", "n2_n_nationkey")
    o = _join(_read(paths, "orders", ["o_orderkey", "o_custkey"]), c,
              "o_custkey", "c_custkey")
    j = _join(_join(li, s, "l_suppkey", "s_suppkey"), o, "l_orderkey",
              "o_orderkey")
    sn, cn = j["n1_n_name"], j["n2_n_name"]
    j = j.filter(pc.or_(
        pc.and_(pc.equal(sn, "FRANCE"), pc.equal(cn, "GERMANY")),
        pc.and_(pc.equal(sn, "GERMANY"), pc.equal(cn, "FRANCE"))))
    t = pa.table({"supp_nation": j["n1_n_name"], "cust_nation": j["n2_n_name"],
                  "l_year": pc.year(j["l_shipdate"]), "v": _revenue(j)})
    keys = ["supp_nation", "cust_nation", "l_year"]
    g = t.group_by(keys).aggregate([("v", "sum")]).sort_by(
        [(k, "ascending") for k in keys])
    return [g[k] for k in keys] + [g["v_sum"]]


def _tpch_q8(paths) -> List[pa.Array]:
    p = _read(paths, "part", ["p_partkey", "p_type"])
    p = p.filter(pc.equal(p["p_type"], "ECONOMY ANODIZED STEEL"))
    r = _read(paths, "region", ["r_regionkey", "r_name"])
    r = r.filter(pc.equal(r["r_name"], "AMERICA"))
    n1 = _join(_nations(paths, "n1_"), r, "n1_n_regionkey", "r_regionkey")
    c = _join(_read(paths, "customer", ["c_custkey", "c_nationkey"]), n1,
              "c_nationkey", "n1_n_nationkey")
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = _join(o.filter(_between(o["o_orderdate"], _date(1995, 1, 1),
                                _date(1996, 12, 31))),
              c.select(["c_custkey"]), "o_custkey", "c_custkey")
    s = _join(_read(paths, "supplier", ["s_suppkey", "s_nationkey"]),
              _nations(paths, "n2_"), "s_nationkey", "n2_n_nationkey")
    li = _read(paths, "lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                                   "l_extendedprice", "l_discount"])
    j = _join(_join(_join(li, p.select(["p_partkey"]), "l_partkey",
                          "p_partkey"), o, "l_orderkey", "o_orderkey"),
              s, "l_suppkey", "s_suppkey")
    v = _revenue(j)
    t = pa.table({"o_year": pc.year(j["o_orderdate"]), "v": v,
                  "b": pc.if_else(pc.equal(j["n2_n_name"], "BRAZIL"), v,
                                  0.0)})
    g = t.group_by("o_year").aggregate([("b", "sum"), ("v", "sum")]
                                       ).sort_by("o_year")
    return [g["o_year"], pc.divide(g["b_sum"], g["v_sum"])]


def _tpch_q9(paths) -> List[pa.Array]:
    p = _read(paths, "part", ["p_partkey", "p_name"])
    p = p.filter(pc.match_like(p["p_name"], "%green%"))
    li = _read(paths, "lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                                   "l_quantity", "l_extendedprice",
                                   "l_discount"])
    ps = _read(paths, "partsupp", ["ps_partkey", "ps_suppkey",
                                   "ps_supplycost"])
    j = _join(li, p.select(["p_partkey"]), "l_partkey", "p_partkey")
    j = j.join(ps, ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"],
               join_type="inner")
    s = _join(_read(paths, "supplier", ["s_suppkey", "s_nationkey"]),
              _read(paths, "nation", ["n_nationkey", "n_name"]),
              "s_nationkey", "n_nationkey")
    j = _join(_join(j, s, "l_suppkey", "s_suppkey"),
              _read(paths, "orders", ["o_orderkey", "o_orderdate"]),
              "l_orderkey", "o_orderkey")
    amount = pc.subtract(_revenue(j), pc.multiply(j["ps_supplycost"],
                                                  j["l_quantity"]))
    t = pa.table({"nation": j["n_name"], "o_year": pc.year(j["o_orderdate"]),
                  "a": amount})
    g = _sorted(t.group_by(["nation", "o_year"]).aggregate([("a", "sum")]),
                [("nation", "ascending"), ("o_year", "descending")])
    return [g["nation"], g["o_year"], g["a_sum"]]


def _tpch_q11(paths) -> List[pa.Array]:
    n = _read(paths, "nation", ["n_nationkey", "n_name"])
    n = n.filter(pc.equal(n["n_name"], "GERMANY"))
    s = _join(_read(paths, "supplier", ["s_suppkey", "s_nationkey"]),
              n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    ps = _join(_read(paths, "partsupp", ["ps_partkey", "ps_suppkey",
                                         "ps_supplycost", "ps_availqty"]),
               s.select(["s_suppkey"]), "ps_suppkey", "s_suppkey")
    v = pc.multiply(ps["ps_supplycost"], ps["ps_availqty"])
    total = pc.sum(v).as_py() * 0.0001
    g = pa.table({"ps_partkey": ps["ps_partkey"], "v": v}).group_by(
        "ps_partkey").aggregate([("v", "sum")])
    g = g.filter(pc.greater(g["v_sum"], total)).sort_by(
        [("v_sum", "descending")])
    return [g["ps_partkey"], g["v_sum"]]


def _tpch_q16(paths) -> List[pa.Array]:
    s = _read(paths, "supplier", ["s_suppkey", "s_comment"])
    bad = s.filter(pc.match_like(s["s_comment"],
                                 "%Customer%Complaints%"))["s_suppkey"]
    p = _read(paths, "part", ["p_partkey", "p_brand", "p_type", "p_size"])
    p = p.filter(pc.and_(pc.and_(
        pc.not_equal(p["p_brand"], "Brand#45"),
        pc.invert(pc.match_like(p["p_type"], "MEDIUM POLISHED%"))),
        pc.is_in(p["p_size"], value_set=pa.array(
            [49, 14, 23, 45, 19, 3, 36, 9], p["p_size"].type))))
    ps = _read(paths, "partsupp", ["ps_partkey", "ps_suppkey"])
    ps = ps.filter(pc.invert(pc.is_in(ps["ps_suppkey"], value_set=bad)))
    j = _join(ps, p, "ps_partkey", "p_partkey")
    keys = ["p_brand", "p_type", "p_size"]
    g = j.group_by(keys).aggregate([("ps_suppkey", "count_distinct")])
    g = _sorted(g, [("ps_suppkey_count_distinct", "descending")]
                + [(k, "ascending") for k in keys])
    return [g[k] for k in keys] + [g["ps_suppkey_count_distinct"]]


def _tpch_q18(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_orderkey", "l_quantity"])
    per = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = per.filter(pc.greater(per["l_quantity_sum"], 250))["l_orderkey"]
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_orderdate",
                                "o_totalprice"])
    o = _join(o.filter(pc.is_in(o["o_orderkey"], value_set=big)),
              _read(paths, "customer", ["c_custkey", "c_name"]),
              "o_custkey", "c_custkey")
    j = _join(li, o, "l_orderkey", "o_orderkey")
    keys = ["c_name", "o_custkey", "l_orderkey", "o_orderdate",
            "o_totalprice"]
    g = _sorted(j.group_by(keys).aggregate([("l_quantity", "sum")]),
                [("o_totalprice", "descending"), ("o_orderdate", "ascending")])
    return [g[k] for k in keys] + [g["l_quantity_sum"]]


def _tpch_q21(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_orderkey", "l_suppkey",
                                   "l_receiptdate", "l_commitdate"])
    is_late = pc.greater(li["l_receiptdate"], li["l_commitdate"])
    late = li.filter(is_late)
    # EXISTS another supplier on the order: two or more distinct ones;
    # NOT EXISTS another late one: the late rows name one supplier only
    n_all = li.group_by("l_orderkey").aggregate(
        [("l_suppkey", "count_distinct")]).rename_columns(["k", "n_all"])
    n_late = late.group_by("l_orderkey").aggregate(
        [("l_suppkey", "count_distinct")]).rename_columns(["k", "n_late"])
    keep = _join(n_all.filter(pc.greater_equal(n_all["n_all"], 2)),
                 n_late.filter(pc.equal(n_late["n_late"], 1)), "k", "k")
    l1 = _join(late, keep.select(["k"]), "l_orderkey", "k")
    o = _read(paths, "orders", ["o_orderkey", "o_orderstatus"])
    o = o.filter(pc.equal(o["o_orderstatus"], "F"))
    n = _read(paths, "nation", ["n_nationkey", "n_name"])
    n = n.filter(pc.equal(n["n_name"], "SAUDI ARABIA"))
    s = _join(_read(paths, "supplier", ["s_suppkey", "s_name",
                                        "s_nationkey"]),
              n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    j = _join(_join(l1, o.select(["o_orderkey"]), "l_orderkey",
                    "o_orderkey"), s, "l_suppkey", "s_suppkey")
    g = _sorted(j.group_by("s_name").aggregate([("l_suppkey", "count",
                                                 _EVERY)]),
                [("l_suppkey_count", "descending"), ("s_name", "ascending")])
    return [g["s_name"], g["l_suppkey_count"]]


def _tpch_q22(paths) -> List[pa.Array]:
    codes = pa.array(["13", "31", "23", "29", "30", "18", "17"])
    c = _read(paths, "customer", ["c_custkey", "c_phone", "c_acctbal"])
    code = pc.utf8_slice_codeunits(c["c_phone"], 0, 2)
    c = c.append_column("cntrycode", code).filter(
        pc.is_in(code, value_set=codes))
    avg = pc.mean(c.filter(pc.greater(c["c_acctbal"], 0.0))["c_acctbal"]
                  ).as_py()
    buyers = pc.unique(_read(paths, "orders", ["o_custkey"])["o_custkey"])
    c = c.filter(pc.and_(pc.greater(c["c_acctbal"], avg),
                         pc.invert(pc.is_in(c["c_custkey"],
                                            value_set=buyers))))
    g = c.group_by("cntrycode").aggregate([
        ("c_custkey", "count", _EVERY), ("c_acctbal", "sum")]
    ).sort_by("cntrycode")
    return [g["cntrycode"], g["c_custkey_count"], g["c_acctbal_sum"]]


# -- the classic path's TPC-H queries (phase 6e) --------------------------

def _europe_suppliers(paths) -> pa.Table:
    """Suppliers in EUROPE with their nation's name."""
    r = _read(paths, "region", ["r_regionkey", "r_name"])
    r = r.filter(pc.equal(r["r_name"], "EUROPE"))
    n = _join(_read(paths, "nation", ["n_nationkey", "n_name",
                                      "n_regionkey"]),
              r.select(["r_regionkey"]), "n_regionkey", "r_regionkey")
    s = _read(paths, "supplier", ["s_suppkey", "s_name", "s_address",
                                  "s_nationkey", "s_phone", "s_acctbal",
                                  "s_comment"])
    return _join(s, n.select(["n_nationkey", "n_name"]), "s_nationkey",
                 "n_nationkey")


def _tpch_q2(paths) -> List[pa.Array]:
    s = _europe_suppliers(paths)
    ps = _join(_read(paths, "partsupp", ["ps_partkey", "ps_suppkey",
                                         "ps_supplycost"]),
               s, "ps_suppkey", "s_suppkey")
    low = ps.group_by("ps_partkey").aggregate([("ps_supplycost", "min")])
    p = _read(paths, "part", ["p_partkey", "p_mfgr", "p_type", "p_size"])
    p = p.filter(pc.and_(pc.equal(p["p_size"], 15),
                         pc.match_like(p["p_type"], "%BRASS")))
    j = _join(_join(ps, p, "ps_partkey", "p_partkey"), low, "ps_partkey",
              "ps_partkey")
    j = j.filter(pc.equal(j["ps_supplycost"], j["ps_supplycost_min"]))
    # the join keeps ps_partkey, which equals p_partkey
    j = _sorted(j, [("s_acctbal", "descending"), ("n_name", "ascending"),
                    ("s_name", "ascending"), ("ps_partkey", "ascending")]
                ).slice(0, 100)
    return [j[c] for c in ("s_acctbal", "s_name", "n_name", "ps_partkey",
                           "p_mfgr", "s_address", "s_phone", "s_comment")]


def _tpch_q13(paths) -> List[pa.Array]:
    o = _read(paths, "orders", ["o_orderkey", "o_custkey", "o_comment"])
    o = o.filter(pc.invert(pc.match_like(o["o_comment"],
                                         "%special%requests%")))
    per = o.group_by("o_custkey").aggregate([("o_orderkey", "count")])
    c = _read(paths, "customer", ["c_custkey"])
    j = c.join(per, "c_custkey", "o_custkey", join_type="left outer")
    counts = pc.fill_null(j["o_orderkey_count"], 0)
    g = pa.table({"c_count": counts}).group_by("c_count").aggregate(
        [("c_count", "count", _EVERY)])
    g = _sorted(g, [("c_count_count", "descending"),
                    ("c_count", "descending")])
    return [g["c_count"], g["c_count_count"]]


def _tpch_q15(paths) -> List[pa.Array]:
    rev = _tpch_q15_revenue(paths)
    best = pc.max(rev[1]).as_py()
    top = pa.table({"supplier_no": rev[0], "total_revenue": rev[1]})
    top = top.filter(pc.equal(top["total_revenue"], best))
    s = _read(paths, "supplier", ["s_suppkey", "s_name", "s_address",
                                  "s_phone"])
    j = _join(s, top, "s_suppkey", "supplier_no").sort_by("s_suppkey")
    return [j[c] for c in ("s_suppkey", "s_name", "s_address", "s_phone",
                           "total_revenue")]


def _tpch_q17(paths) -> List[pa.Array]:
    p = _read(paths, "part", ["p_partkey", "p_brand", "p_container"])
    p = p.filter(pc.and_(pc.equal(p["p_brand"], "Brand#23"),
                         pc.equal(p["p_container"], "MED BOX")))
    li = _read(paths, "lineitem", ["l_partkey", "l_quantity",
                                   "l_extendedprice"])
    avg = li.group_by("l_partkey").aggregate([("l_quantity", "mean")])
    j = _join(_join(li, p.select(["p_partkey"]), "l_partkey", "p_partkey"),
              avg, "l_partkey", "l_partkey")
    j = j.filter(pc.less(j["l_quantity"],
                         pc.multiply(j["l_quantity_mean"], 0.2)))
    total = pc.sum(j["l_extendedprice"]).as_py()
    return [pa.array([None if total is None else total / 7.0],
                     pa.float64())]


def _tpch_q20(paths) -> List[pa.Array]:
    p = _read(paths, "part", ["p_partkey", "p_name"])
    forest = p.filter(pc.starts_with(p["p_name"], "forest"))["p_partkey"]
    li = _read(paths, "lineitem", ["l_partkey", "l_suppkey", "l_quantity",
                                   "l_shipdate"])
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
        pc.less(li["l_shipdate"], _date(1995, 1, 1))))
    qty = li.group_by(["l_partkey", "l_suppkey"]).aggregate(
        [("l_quantity", "sum")])
    ps = _read(paths, "partsupp", ["ps_partkey", "ps_suppkey",
                                   "ps_availqty"])
    ps = ps.filter(pc.is_in(ps["ps_partkey"], value_set=forest))
    j = ps.join(qty, ["ps_partkey", "ps_suppkey"], ["l_partkey",
                                                    "l_suppkey"])
    ok = pc.unique(j.filter(pc.greater(
        j["ps_availqty"], pc.multiply(j["l_quantity_sum"], 0.5)))[
            "ps_suppkey"])
    n = _read(paths, "nation", ["n_nationkey", "n_name"])
    n = n.filter(pc.equal(n["n_name"], "CANADA"))
    s = _read(paths, "supplier", ["s_suppkey", "s_name", "s_address",
                                  "s_nationkey"])
    s = _join(s.filter(pc.is_in(s["s_suppkey"], value_set=ok)),
              n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    s = s.sort_by("s_name")
    return [s["s_name"], s["s_address"]]


# -- ClickBench queries of the single-table slice (benchmark/clickbench) --

def _hits(paths, cols) -> pa.Table:
    return pq.read_table(paths["hits"], columns=cols)


def _seconds(a) -> pa.Array:
    """Epoch seconds (int64) viewed as timestamp[s]."""
    return pc.cast(a, pa.timestamp("s"))


def _count_distinct(col: str) -> tuple:
    return (col, "count_distinct", pc.CountOptions(mode="only_valid"))


def _cb_q4(paths) -> List[pa.Array]:
    u = _hits(paths, ["UserID"])["UserID"]
    return [pa.array([pc.count_distinct(u).as_py()], pa.int64())]


def _cb_q5(paths) -> List[pa.Array]:
    s = _hits(paths, ["SearchPhrase"])["SearchPhrase"]
    return [pa.array([pc.count_distinct(s).as_py()], pa.int64())]


def _distinct_users(t: pa.Table, keys: List[str]) -> List[pa.Array]:
    g = t.group_by(keys).aggregate([_count_distinct("UserID")]).sort_by(
        [("UserID_count_distinct", "descending")])
    return [g[k] for k in keys] + [g["UserID_count_distinct"]]


def _cb_q8(paths) -> List[pa.Array]:
    return _distinct_users(_hits(paths, ["RegionID", "UserID"]), ["RegionID"])


def _cb_q9(paths) -> List[pa.Array]:
    h = _hits(paths, ["RegionID", "AdvEngineID", "ResolutionWidth",
                      "UserID"])
    g = h.group_by("RegionID").aggregate([
        ("AdvEngineID", "sum"), ("AdvEngineID", "count", _EVERY),
        ("ResolutionWidth", "mean"), _count_distinct("UserID")]).sort_by(
            [("AdvEngineID_count", "descending")])
    return [g["RegionID"], g["AdvEngineID_sum"], g["AdvEngineID_count"],
            g["ResolutionWidth_mean"], g["UserID_count_distinct"]]


def _cb_q10(paths) -> List[pa.Array]:
    h = _hits(paths, ["MobilePhoneModel", "UserID"])
    h = h.filter(pc.not_equal(h["MobilePhoneModel"], ""))
    return _distinct_users(h, ["MobilePhoneModel"])


def _cb_q11(paths) -> List[pa.Array]:
    h = _hits(paths, ["MobilePhone", "MobilePhoneModel", "UserID"])
    h = h.filter(pc.not_equal(h["MobilePhoneModel"], ""))
    return _distinct_users(h, ["MobilePhone", "MobilePhoneModel"])


def _cb_q13(paths) -> List[pa.Array]:
    h = _hits(paths, ["SearchPhrase", "UserID"])
    h = h.filter(pc.not_equal(h["SearchPhrase"], ""))
    return _distinct_users(h, ["SearchPhrase"])


def _cb_q18(paths) -> List[pa.Array]:
    h = _hits(paths, ["UserID", "EventTime", "SearchPhrase"])
    t = pa.table({"UserID": h["UserID"],
                  "m": pc.minute(_seconds(h["EventTime"])),
                  "SearchPhrase": h["SearchPhrase"]})
    g = t.group_by(["UserID", "m", "SearchPhrase"]).aggregate([
        ("UserID", "count", _EVERY)]).sort_by(
            [("UserID_count", "descending")])
    return [g["UserID"], g["m"], g["SearchPhrase"], g["UserID_count"]]


def _cb_q22(paths) -> List[pa.Array]:
    h = _hits(paths, ["SearchPhrase", "URL", "Title", "UserID"])
    h = h.filter(pc.and_(pc.and_(
        pc.match_like(h["Title"], "%Google%"),
        pc.invert(pc.match_like(h["URL"], "%.google.%"))),
        pc.not_equal(h["SearchPhrase"], "")))
    g = h.group_by("SearchPhrase").aggregate([
        ("URL", "min"), ("Title", "min"), ("SearchPhrase", "count", _EVERY),
        _count_distinct("UserID")]).sort_by(
            [("SearchPhrase_count", "descending")])
    return [g["SearchPhrase"], g["URL_min"], g["Title_min"],
            g["SearchPhrase_count"], g["UserID_count_distinct"]]


def _phrases_by_time(paths, with_phrase: bool) -> List[pa.Array]:
    """q24 / q26: the first 10 non-empty phrases by EventTime (then by the
    phrase); a stable sort keeps the lowest row ids among ties, as the
    fused select does."""
    h = _hits(paths, ["SearchPhrase", "EventTime"])
    h = h.filter(pc.not_equal(h["SearchPhrase"], ""))
    keys = [("EventTime", "ascending")] + (
        [("SearchPhrase", "ascending")] if with_phrase else [])
    return [h.take(pc.sort_indices(h, sort_keys=keys)[:10])["SearchPhrase"]]


def _minute_views(paths, counter: bool, offset: int) -> List[pa.Array]:
    """q42 (`counter`: CounterID = 62 and EventDate in 2013-07-14..15,
    OFFSET 1000) and its open variant: page views per minute."""
    h = _hits(paths, ["EventTime", "CounterID", "EventDate", "IsRefresh",
                      "DontCountHits"])
    m = pc.and_(pc.equal(h["IsRefresh"], 0), pc.equal(h["DontCountHits"], 0))
    if counter:
        day = (datetime.date(2013, 7, 14) - datetime.date(1970, 1, 1)).days
        m = pc.and_(m, pc.and_(pc.equal(h["CounterID"], 62), pc.and_(
            pc.greater_equal(h["EventDate"], day),
            pc.less_equal(h["EventDate"], day + 1))))
    h = h.filter(m)
    t = pa.table({"M": pc.floor_temporal(_seconds(h["EventTime"]), 1,
                                         "minute")})
    g = t.group_by("M").aggregate([("M", "count", _EVERY)]).sort_by("M")
    g = g.slice(offset, 10)
    return [g["M"], g["M_count"]]


def _cb_q19(paths) -> List[pa.Array]:
    u = _hits(paths, ["UserID"])["UserID"]
    return [u.filter(pc.equal(u, 435090932899640449)).combine_chunks()]


def _cb_q23(paths) -> List[pa.Array]:
    """Every column of the rows whose URL holds 'google', ordered by
    EventTime, cut after the rows tied with the tenth (the tie rule of
    `CUTS`)."""
    t = _hits(paths, ["URL", "EventTime"])
    times = t.filter(pc.match_like(t["URL"], "%google%"))["EventTime"]
    if len(times) == 0:
        whole = pq.read_schema(paths["hits"])
        return [pa.array([], f.type) for f in whole]
    tenth = pc.sort_indices(times)[min(9, len(times) - 1)].as_py()
    cut = times[tenth].as_py()
    import pyarrow.dataset as ds
    rows = ds.dataset(paths["hits"]).to_table(filter=(
        ds.field("EventTime") <= cut) & pc.match_like(ds.field("URL"),
                                                     "%google%"))
    rows = rows.take(pc.sort_indices(rows["EventTime"]))
    return [rows[c].combine_chunks() for c in rows.column_names]


def _cb_q39(paths) -> List[pa.Array]:
    """Page views by source and destination of CounterID 62 in July 2013
    without refreshes, rows 1001-1010 by count."""
    t = _hits(paths, ["TraficSourceID", "SearchEngineID", "AdvEngineID",
                      "Referer", "URL", "CounterID", "EventDate",
                      "IsRefresh"])
    day = pc.cast(pc.cast(t["EventDate"], pa.int32()), pa.date32())
    t = t.filter(pc.and_(pc.and_(pc.equal(t["CounterID"], 62),
                                 _between(day, _date(2013, 7, 1),
                                          _date(2013, 7, 31))),
                         pc.equal(t["IsRefresh"], 0)))
    direct = pc.and_(pc.equal(t["SearchEngineID"], 0),
                     pc.equal(t["AdvEngineID"], 0))
    src = pc.if_else(direct, t["Referer"], pa.scalar("", pa.string()))
    keys = ["TraficSourceID", "SearchEngineID", "AdvEngineID", "Src", "Dst"]
    g = pa.table({"TraficSourceID": t["TraficSourceID"],
                  "SearchEngineID": t["SearchEngineID"],
                  "AdvEngineID": t["AdvEngineID"], "Src": src,
                  "Dst": t["URL"]}).group_by(keys).aggregate(
        [("Dst", "count", _EVERY)])
    g = _sorted(g, [("Dst_count", "descending")])
    return [g[k] for k in keys] + [g["Dst_count"]]


def _cb_distinct_chained(paths) -> List[pa.Array]:
    h = _hits(paths, ["RegionID", "UserID"])
    g = h.group_by("RegionID").aggregate([_count_distinct("UserID")])
    t = pa.table({"r": pc.add(pc.cast(g["RegionID"], pa.int64()), 1),
                  "u": g["UserID_count_distinct"]}).sort_by(
        [("u", "descending"), ("r", "ascending")]).slice(0, 10)
    return [t["r"], t["u"]]


def _cb_distinct_fold(paths) -> List[pa.Array]:
    h = _hits(paths, ["TraficSourceID", "SearchEngineID", "AdvEngineID"])
    g = h.group_by("TraficSourceID").aggregate([
        _count_distinct("SearchEngineID"), _count_distinct("AdvEngineID"),
        ("TraficSourceID", "count", _EVERY)]).sort_by(
            [("TraficSourceID_count", "descending"),
             ("TraficSourceID", "ascending")])
    return [g["TraficSourceID"], g["SearchEngineID_count_distinct"],
            g["AdvEngineID_count_distinct"], g["TraficSourceID_count"]]


ORACLES = {"cb_filter": _cb_filter, "cb_like": _cb_like,
           "tpch_q6": _tpch_q6, "cb_groupby": _cb_groupby,
           "cb_q15": _cb_q15, "tpch_q15_revenue": _tpch_q15_revenue,
           "tpch_supp_price": _tpch_supp_price, "tpch_q1": _tpch_q1,
           "tpch_q3": _tpch_q3, "tpch_q5": _tpch_q5, "tpch_q10": _tpch_q10,
           "tpch_q12": _tpch_q12, "tpch_q14": _tpch_q14,
           "tpch_q19": _tpch_q19,
           "tpch_q4": _tpch_q4, "tpch_q7": _tpch_q7, "tpch_q8": _tpch_q8,
           "tpch_q9": _tpch_q9, "tpch_q11": _tpch_q11,
           "tpch_q16": _tpch_q16, "tpch_q18": _tpch_q18,
           "tpch_q21": _tpch_q21, "tpch_q22": _tpch_q22,
           "cb_q4": _cb_q4, "cb_q5": _cb_q5, "cb_q8": _cb_q8,
           "cb_q9": _cb_q9, "cb_q10": _cb_q10, "cb_q11": _cb_q11,
           "cb_q13": _cb_q13, "cb_q18": _cb_q18, "cb_q22": _cb_q22,
           "cb_q24": lambda paths: _phrases_by_time(paths, False),
           "cb_q26": lambda paths: _phrases_by_time(paths, True),
           "cb_q42": lambda paths: _minute_views(paths, True, 1000),
           "cb_q42_open": lambda paths: _minute_views(paths, False, 0),
           "cb_distinct_chained": _cb_distinct_chained,
           "cb_distinct_fold": _cb_distinct_fold,
           "tpch_q2": _tpch_q2, "tpch_q13": _tpch_q13, "tpch_q15": _tpch_q15,
           "tpch_q17": _tpch_q17, "tpch_q20": _tpch_q20, "cb_q19": _cb_q19,
           "cb_q23": _cb_q23, "cb_q39": _cb_q39}

# -- TPC-H over the specification's DECIMAL(15,2) money columns ------------

#: the decimal shapes phase 6g of `chip_smoke.py` and
#: `tests/test_torch_decimal.py` run (q14 and q19 as
#: `bench/tpch_queries.py` gives them; q6 with the literal bounds of the
#: bench's `tpch_q6`)
DECIMAL_QUERIES = {
    "dec_q6": "SELECT sum(l_extendedprice * l_discount) AS revenue "
              "FROM lineitem WHERE l_shipdate >= date '1994-01-01' "
              "AND l_shipdate < date '1995-01-01' "
              "AND l_discount between 0.05 and 0.07 AND l_quantity < 24",
    "dec_q14": 14, "dec_q19": 19,
    "dec_qty_by_flag": "SELECT l_returnflag, sum(l_quantity) AS sum_qty "
                       "FROM lineitem GROUP BY l_returnflag "
                       "ORDER BY l_returnflag",
    "dec_qty_lt_24": "SELECT count(*) AS c FROM lineitem "
                     "WHERE l_quantity < 24",
}


def decimal_sql(name: str) -> str:
    from liquid_tpu_torch.bench.tpch_queries import QUERIES
    q = DECIMAL_QUERIES[name]
    return QUERIES[q] if isinstance(q, int) else q


def _dec(v: str) -> pa.Scalar:
    from decimal import Decimal
    return pa.scalar(Decimal(v))


def _dec_revenue(t: pa.Table) -> pa.Array:
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(_dec("1"), t["l_discount"]))


def _dec_q6(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_extendedprice", "l_discount",
                                   "l_shipdate", "l_quantity"])
    m = pc.and_(
        pc.and_(pc.greater_equal(li["l_shipdate"], _date(1994, 1, 1)),
                pc.less(li["l_shipdate"], _date(1995, 1, 1))),
        pc.and_(_between(li["l_discount"], _dec("0.05"), _dec("0.07")),
                pc.less(li["l_quantity"], _dec("24"))))
    f = li.filter(m)
    return [pa.array([pc.sum(pc.multiply(f["l_extendedprice"],
                                         f["l_discount"])).as_py()])]


def _dec_q14(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_partkey", "l_extendedprice",
                                   "l_discount", "l_shipdate"])
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], _date(1995, 9, 1)),
        pc.less(li["l_shipdate"], _date(1995, 10, 1))))
    j = _join(li, _read(paths, "part", ["p_partkey", "p_type"]),
              "l_partkey", "p_partkey")
    rev = _dec_revenue(j)
    promo = pc.sum(pc.if_else(pc.starts_with(j["p_type"], "PROMO"), rev,
                              pa.scalar(0, rev.type))).as_py()
    return [pa.array([100.0 * float(promo) / float(pc.sum(rev).as_py())],
                     pa.float64())]


def _dec_q19(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_partkey", "l_quantity",
                                   "l_extendedprice", "l_discount",
                                   "l_shipmode", "l_shipinstruct"])
    li = li.filter(pc.and_(
        pc.is_in(li["l_shipmode"], pa.array(["AIR", "AIR REG"])),
        pc.equal(li["l_shipinstruct"], "DELIVER IN PERSON")))
    j = _join(li, _read(paths, "part", ["p_partkey", "p_brand",
                                        "p_container", "p_size"]),
              "l_partkey", "p_partkey")
    keep = None
    for brand, size, qty, cont in (
            ("Brand#12", 5, 1, "SM"), ("Brand#23", 10, 10, "MED"),
            ("Brand#34", 15, 20, "LG")):
        kinds = ("CASE", "BOX", "PACK", "PKG") if cont != "MED" else (
            "BAG", "BOX", "PKG", "PACK")
        branch = pc.and_(pc.and_(
            pc.equal(j["p_brand"], brand),
            pc.is_in(j["p_container"],
                     pa.array([f"{cont} {k}" for k in kinds]))), pc.and_(
            _between(j["l_quantity"], _dec(str(qty)), _dec(str(qty + 10))),
            _between(j["p_size"], 1, size)))
        keep = branch if keep is None else pc.or_(keep, branch)
    return [pa.array([pc.sum(_dec_revenue(j.filter(keep))).as_py()])]


def _dec_qty_by_flag(paths) -> List[pa.Array]:
    li = _read(paths, "lineitem", ["l_returnflag", "l_quantity"])
    g = li.group_by("l_returnflag").aggregate([("l_quantity", "sum")]
                                              ).sort_by("l_returnflag")
    return [g["l_returnflag"], g["l_quantity_sum"]]


def _dec_qty_lt_24(paths) -> List[pa.Array]:
    q = _read(paths, "lineitem", ["l_quantity"])["l_quantity"]
    return [pa.array([pc.sum(pc.less(q, _dec("24"))).as_py()], pa.int64())]


DECIMAL_ORACLES = {"dec_q6": _dec_q6, "dec_q14": _dec_q14,
                   "dec_q19": _dec_q19, "dec_qty_by_flag": _dec_qty_by_flag,
                   "dec_qty_lt_24": _dec_qty_lt_24}



# -- TPC-DS: the window and grouping-set queries of phase 6h ---------------
#
# As `bench/tpcds_queries.py` gives them, over the tables of
# `bench/tpcds_data.py`: windows by numpy over pyarrow's groups, ROLLUP as
# one `group_by` per level.

def _order(t: pa.Table, keys) -> pa.Table:
    """t sorted by (column, descending, nulls first) keys."""
    cols, sort_keys = {}, []
    for i, (k, desc, nulls_first) in enumerate(keys):
        isnull = pc.is_null(t[k])
        cols[f"n{i}"] = pc.invert(isnull) if nulls_first else isnull
        cols[f"k{i}"] = t[k]
        sort_keys += [(f"n{i}", "ascending"),
                      (f"k{i}", "descending" if desc else "ascending")]
    return t.take(pc.sort_indices(pa.table(cols), sort_keys=sort_keys))


def _segments(keys: np.ndarray):
    """(start, end) of each run of equal values in a sorted key array."""
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) \
        if len(keys) else np.zeros(0, np.int64)
    return zip(starts, np.r_[starts[1:], len(keys)])


def _ds_q98(paths) -> List[pa.Array]:
    """sum(sum(x)) OVER (PARTITION BY i_class) over a star join."""
    ss = _read(paths, "store_sales", ["ss_item_sk", "ss_sold_date_sk",
                                      "ss_ext_sales_price"])
    it = _read(paths, "item", ["i_item_sk", "i_item_id", "i_item_desc",
                               "i_category", "i_class", "i_current_price"])
    it = it.filter(pc.is_in(it["i_category"], value_set=pa.array(
        ["Sports", "Books", "Home"])))
    d = _read(paths, "date_dim", ["d_date_sk", "d_date"])
    d = d.filter(_between(d["d_date"], _date(1999, 2, 22),
                          _date(1999, 3, 24)))
    j = _join(_join(ss, it, "ss_item_sk", "i_item_sk"),
              d.select(["d_date_sk"]), "ss_sold_date_sk", "d_date_sk")
    keys = ["i_item_id", "i_item_desc", "i_category", "i_class",
            "i_current_price"]
    g = j.group_by(keys).aggregate([("ss_ext_sales_price", "sum")]) \
        .rename_columns(keys + ["itemrevenue"])
    cls = g.group_by("i_class").aggregate([("itemrevenue", "sum")])
    g = g.join(cls, "i_class")
    g = g.append_column("revenueratio", pc.divide(
        pc.multiply(g["itemrevenue"], 100), g["itemrevenue_sum"]))
    g = _order(g, [(k, False, False) for k in
                   ("i_category", "i_class", "i_item_id", "i_item_desc",
                    "revenueratio")])
    return [g[c] for c in keys + ["itemrevenue", "revenueratio"]]


def _ds_rollup(j: pa.Table, keys: List[str], aggs) -> pa.Table:
    """ROLLUP(keys): one grouping per key prefix, longest first, the keys
    left out NULL, and `__level` the number left out."""
    parts = []
    for i in range(len(keys), -1, -1):
        if i:
            g = j.group_by(keys[:i]).aggregate(aggs)
            g = g.rename_columns(keys[:i] + [f"{c}_{f}" for c, f in aggs])
        else:
            g = pa.table({f"{c}_{f}": [getattr(pc, f)(j[c]).as_py()]
                          for c, f in aggs})
        for k in keys[i:]:
            g = g.append_column(k, pa.nulls(g.num_rows, j.schema.field(
                k).type))
        g = g.append_column("__level", pa.array(
            [len(keys) - i] * g.num_rows, pa.int64()))
        parts.append(g.select(keys + [f"{c}_{f}" for c, f in aggs]
                              + ["__level"]))
    return pa.concat_tables(parts)


def _ds_q27(paths) -> List[pa.Array]:
    """ROLLUP(i_item_id, s_state) with grouping() over a five-table
    join; its whole answer (`CUTS`)."""
    ss = _read(paths, "store_sales", [
        "ss_sold_date_sk", "ss_item_sk", "ss_store_sk", "ss_cdemo_sk",
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price"])
    cd = _read(paths, "customer_demographics", [
        "cd_demo_sk", "cd_gender", "cd_marital_status", "cd_education_status"])
    cd = cd.filter(pc.and_(pc.and_(
        pc.equal(cd["cd_gender"], "M"), pc.equal(cd["cd_marital_status"],
                                                 "S")),
        pc.equal(cd["cd_education_status"], "College")))
    d = _read(paths, "date_dim", ["d_date_sk", "d_year"])
    d = d.filter(pc.equal(d["d_year"], 2002))
    st = _read(paths, "store", ["s_store_sk", "s_state"])
    st = st.filter(pc.is_in(st["s_state"], value_set=pa.array(
        ["AL", "CA", "GA", "IL", "IN", "KS"])))
    it = _read(paths, "item", ["i_item_sk", "i_item_id"])
    j = _join(ss, cd.select(["cd_demo_sk"]), "ss_cdemo_sk", "cd_demo_sk")
    j = _join(j, d.select(["d_date_sk"]), "ss_sold_date_sk", "d_date_sk")
    j = _join(j, st, "ss_store_sk", "s_store_sk")
    j = _join(j, it, "ss_item_sk", "i_item_sk")
    aggs = [(c, "mean") for c in ("ss_quantity", "ss_list_price",
                                  "ss_coupon_amt", "ss_sales_price")]
    g = _ds_rollup(j, ["i_item_id", "s_state"], aggs)
    g = _order(g, [("i_item_id", False, True), ("s_state", False, True)])
    g_state = pc.cast(pc.greater_equal(g["__level"], 1), pa.int64())
    return [g["i_item_id"], g["s_state"], g_state] + [
        g[f"{c}_mean"] for c, _ in aggs]


def _ds_q86(paths) -> List[pa.Array]:
    """rank() OVER a ROLLUP(i_category, i_class), partitioned by the
    grouping level and, at level 0, the category; its whole answer."""
    ws = _read(paths, "web_sales", ["ws_sold_date_sk", "ws_item_sk",
                                    "ws_net_paid"])
    d = _read(paths, "date_dim", ["d_date_sk", "d_month_seq"])
    d = d.filter(_between(d["d_month_seq"], 24, 35))
    it = _read(paths, "item", ["i_item_sk", "i_category", "i_class"])
    j = _join(_join(ws, d.select(["d_date_sk"]), "ws_sold_date_sk",
                    "d_date_sk"), it, "ws_item_sk", "i_item_sk")
    g = _ds_rollup(j, ["i_category", "i_class"], [("ws_net_paid", "sum")])
    level = g["__level"].to_numpy()
    parent = np.where(level == 0, g["i_category"].to_numpy(
        zero_copy_only=False), None)
    total = g["ws_net_paid_sum"].to_numpy()
    rank = np.zeros(g.num_rows, np.int64)
    groups: Dict[tuple, List[int]] = {}
    for i, key in enumerate(zip(level.tolist(), parent.tolist())):
        groups.setdefault(key, []).append(i)
    for rows in groups.values():
        v = total[rows]
        rank[rows] = 1 + (v[None, :] > v[:, None]).sum(axis=1)
    g = g.append_column("rank_within_parent", pa.array(rank)) \
        .append_column("__parent", pa.array(parent.tolist(), pa.string()))
    g = _order(g, [("__level", True, True), ("__parent", False, True),
                   ("rank_within_parent", False, False)])
    return [g["ws_net_paid_sum"], g["i_category"], g["i_class"],
            g["__level"], g["rank_within_parent"]]


def _ds_cume_sales(paths, fact: str, pfx: str) -> pa.Table:
    """q51's view: each item's running sum of its daily sales."""
    f = _read(paths, fact, [f"{pfx}_sold_date_sk", f"{pfx}_item_sk",
                            f"{pfx}_sales_price"])
    f = f.filter(pc.is_valid(f[f"{pfx}_item_sk"]))
    d = _read(paths, "date_dim", ["d_date_sk", "d_date", "d_month_seq"])
    d = d.filter(_between(d["d_month_seq"], 24, 27))
    j = _join(f, d.select(["d_date_sk", "d_date"]), f"{pfx}_sold_date_sk",
              "d_date_sk")
    g = j.group_by([f"{pfx}_item_sk", "d_date"]).aggregate([
        (f"{pfx}_sales_price", "sum")])
    g = _order(g, [(f"{pfx}_item_sk", False, False), ("d_date", False, False)])
    v = g[f"{pfx}_sales_price_sum"].to_numpy()
    cume = np.empty_like(v)
    for a, b in _segments(g[f"{pfx}_item_sk"].to_numpy()):
        cume[a:b] = np.cumsum(v[a:b])
    return pa.table({"item_sk": g[f"{pfx}_item_sk"], "d_date": g["d_date"],
                     "cume_sales": cume})


def _ds_q51(paths) -> List[pa.Array]:
    """Running sums in a ROWS frame, a full outer join and a running max
    over a window (NULLs skipped, as SQL's max); its whole answer."""
    web = _ds_cume_sales(paths, "web_sales", "ws").rename_columns(
        ["item_sk", "d_date", "web_sales"])
    store = _ds_cume_sales(paths, "store_sales", "ss").rename_columns(
        ["item_sk", "d_date", "store_sales"])
    m = web.join(store, ["item_sk", "d_date"], join_type="full outer")
    m = _order(m, [("item_sk", False, False), ("d_date", False, False)])
    items = m["item_sk"].to_numpy()
    cols = {}
    for c in ("web_sales", "store_sales"):
        v = m[c].to_numpy(zero_copy_only=False).astype(np.float64)
        run = np.empty_like(v)
        for a, b in _segments(items):
            run[a:b] = np.fmax.accumulate(v[a:b])
        cols[c] = pa.array(run, mask=np.isnan(run))
    keep = pc.fill_null(pc.greater(cols["web_sales"], cols["store_sales"]),
                        False)
    m = m.filter(keep)
    return [m["item_sk"], m["d_date"], m["web_sales"], m["store_sales"],
            cols["web_sales"].filter(keep), cols["store_sales"].filter(keep)]


#: phase 6h's queries, by `bench/tpcds_queries.py` number
TPCDS_QUERIES = (98, 27, 86, 51)
TPCDS_ORACLES = {"ds_q98": _ds_q98, "ds_q27": _ds_q27, "ds_q86": _ds_q86,
                 "ds_q51": _ds_q51}

#: answers cut by a LIMIT that may split rows tied on the ORDER BY keys:
#: (positions of the order-key columns, OFFSET, LIMIT); their oracles
#: return every row in order
CUTS: Dict[str, Tuple[Tuple[int, ...], int, int]] = {
    "cb_q8": ((1,), 0, 10), "cb_q9": ((2,), 0, 10), "cb_q10": ((1,), 0, 10),
    "cb_q11": ((2,), 0, 10), "cb_q13": ((1,), 0, 10),
    "cb_q18": ((3,), 0, 10), "cb_q22": ((3,), 0, 10),
    # TPC-H: q18's o_totalprice, o_orderdate and q21's numwait, s_name
    # under LIMIT 100; q11 orders its whole answer by a value that may tie
    "tpch_q18": ((4, 3), 0, 100), "tpch_q21": ((1, 0), 0, 100),
    "tpch_q11": ((1,), 0, 1 << 40),
    # ClickBench q23 orders SELECT * by EventTime (column 4), which ties;
    # q39's page-view counts tie at its OFFSET 1000 and LIMIT 10 cuts
    "cb_q23": ((4,), 0, 10), "cb_q39": ((5,), 1000, 10),
    # TPC-DS: q98 orders its whole answer by a ratio that may tie; q27, q86
    # and q51 return their whole answers under LIMIT 100 (q86's second key
    # is i_category at level 0, NULL above it)
    "ds_q98": ((2, 3, 0, 1, 6), 0, 1 << 40), "ds_q27": ((0, 1), 0, 100),
    "ds_q86": ((3, 1, 4), 0, 100), "ds_q51": ((0, 1), 0, 100)}


def answers(paths: Dict[str, str], names: Iterable[str]
            ) -> Dict[str, List[pa.Array]]:
    """{query name: its columns} for the named queries."""
    return {n: {**ORACLES, **TPCDS_ORACLES}[n](paths) for n in names}


def _cell_key(v):
    """A hashable, sortable form of a cell: floats to 9 significant
    digits (the rtol 1e-9 gate), NULL first, NaN last."""
    if isinstance(v, float) and v != v:
        return (2,)
    if isinstance(v, float):
        return (1, float(f"{v:.9g}"))
    return (0,) if v is None else (1, v)


def _rows(cols) -> List[tuple]:
    return list(zip(*[c.to_pylist() for c in cols]))


def _same_cut(out: pa.Table, want: List[pa.Array], cut) -> bool:
    """The tie rule over an answer cut by OFFSET / LIMIT (module doc)."""
    keys, offset, limit = cut
    full = _rows(want)
    lo, hi = min(offset, len(full)), min(offset + limit, len(full))
    got = _rows(out.columns)
    if out.num_columns != len(want) or len(got) != hi - lo:
        return False
    if not got:
        return True

    def key(r):
        return tuple(_cell_key(r[i]) for i in keys)

    if [key(r) for r in got] != [key(r) for r in full[lo:hi]]:
        return False
    tied = {key(full[hi - 1])} | ({key(full[lo])} if lo else set())
    if not _same_rows([r for r in got if key(r) not in tied],
                      [r for r in full[lo:hi] if key(r) not in tied]):
        return False
    pool = [r for r in full if key(r) in tied]
    for r in (r for r in got if key(r) in tied):
        hit = next((i for i, w in enumerate(pool) if _close_row(r, w)), None)
        if hit is None:
            return False
        pool.pop(hit)
    return True


def _close_row(a, b) -> bool:
    """Cells equal, floats to rtol 1e-9 (NaN equal to NaN)."""
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float):
            if not (x == y or (x != x and y != y) or abs(x - y) <= 1e-9 * max(
                    abs(x), abs(y))):
                return False
        elif x != y:
            return False
    return True


def _same_rows(a: List[tuple], b: List[tuple]) -> bool:
    """Equal as multisets under `_close_row`: both sorted, the non-float
    cells first, then compared pairwise (rounding the floats to a key
    would split two values that straddle a rounding boundary)."""
    if len(a) != len(b):
        return False

    fcols = {i for r in a + b for i, v in enumerate(r)
             if isinstance(v, float)}

    def order(r):
        return (tuple(_cell_key(v) for i, v in enumerate(r)
                      if i not in fcols)
                + tuple((0,) if v is None else (2,) if v != v else (1, v)
                        for i, v in enumerate(r) if i in fcols))
    return all(_close_row(x, y) for x, y in zip(sorted(a, key=order),
                                                 sorted(b, key=order)))


def same_table(out: pa.Table, want: List[pa.Array],
               cut: Optional[tuple] = None) -> bool:
    """Engine result vs oracle columns: non-float columns exactly equal,
    float columns rtol 1e-9; with `cut` (a `CUTS` entry) under the tie
    rule."""
    if cut is not None:
        return _same_cut(out, want, cut)
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
