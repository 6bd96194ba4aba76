"""TPC-H q5: local supplier volume in ASIA."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date, join, revenue

def answer(db) -> List[pa.Array]:
    r = db.read("region", ["r_regionkey", "r_name"])
    r = r.filter(pc.equal(r["r_name"], "ASIA"))
    n = db.read("nation", ["n_nationkey", "n_name", "n_regionkey"])
    n = join(n, r.select(["r_regionkey"]), "n_regionkey", "r_regionkey")
    s = db.read("supplier", ["s_suppkey", "s_nationkey"])
    s = join(s, n.select(["n_nationkey", "n_name"]), "s_nationkey",
             "n_nationkey")
    o = db.read("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], date(1994, 1, 1)),
        pc.less(o["o_orderdate"], date(1995, 1, 1))))
    o = join(o, db.read("customer", ["c_custkey", "c_nationkey"]),
             "o_custkey", "c_custkey")
    li = db.read("lineitem", ["l_orderkey", "l_suppkey", "l_extendedprice",
                              "l_discount"])
    j = join(join(li, o.select(["o_orderkey", "c_nationkey"]),
                  "l_orderkey", "o_orderkey"), s, "l_suppkey", "s_suppkey")
    j = j.filter(pc.equal(j["c_nationkey"], j["s_nationkey"]))
    g = pa.table({"n_name": j["n_name"], "rev": revenue(j)}).group_by(
        "n_name").aggregate([("rev", "sum")]).sort_by(
            [("rev_sum", "descending")])
    return [g["n_name"], g["rev_sum"]]
