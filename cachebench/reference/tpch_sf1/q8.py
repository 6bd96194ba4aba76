"""TPC-H q8: BRAZIL's market share in AMERICA."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import between, date, join, nations, revenue

def answer(db) -> List[pa.Array]:
    p = db.read("part", ["p_partkey", "p_type"])
    p = p.filter(pc.equal(p["p_type"], "ECONOMY ANODIZED STEEL"))
    r = db.read("region", ["r_regionkey", "r_name"])
    r = r.filter(pc.equal(r["r_name"], "AMERICA"))
    n1 = join(nations(db, "n1_"), r, "n1_n_regionkey", "r_regionkey")
    c = join(db.read("customer", ["c_custkey", "c_nationkey"]), n1,
             "c_nationkey", "n1_n_nationkey")
    o = db.read("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = join(o.filter(between(o["o_orderdate"], date(1995, 1, 1),
                              date(1996, 12, 31))),
             c.select(["c_custkey"]), "o_custkey", "c_custkey")
    s = join(db.read("supplier", ["s_suppkey", "s_nationkey"]),
             nations(db, "n2_"), "s_nationkey", "n2_n_nationkey")
    li = db.read("lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                              "l_extendedprice", "l_discount"])
    j = join(join(join(li, p.select(["p_partkey"]), "l_partkey",
                       "p_partkey"), o, "l_orderkey", "o_orderkey"),
             s, "l_suppkey", "s_suppkey")
    v = revenue(j)
    t = pa.table({"o_year": pc.year(j["o_orderdate"]), "v": v,
                  "b": pc.if_else(pc.equal(j["n2_n_name"], "BRAZIL"), v,
                                  0.0)})
    g = t.group_by("o_year").aggregate([("b", "sum"), ("v", "sum")]
                                       ).sort_by("o_year")
    return [g["o_year"], pc.divide(g["b_sum"], g["v_sum"])]
