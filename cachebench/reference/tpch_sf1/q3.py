"""TPC-H q3: the shipping priority top ten (ties broken by l_orderkey)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date, join, revenue

def answer(db) -> List[pa.Array]:
    c = db.read("customer", ["c_custkey", "c_mktsegment"])
    c = c.filter(pc.equal(c["c_mktsegment"], "BUILDING"))
    o = db.read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                           "o_shippriority"])
    o = o.filter(pc.less(o["o_orderdate"], date(1995, 3, 15)))
    li = db.read("lineitem", ["l_orderkey", "l_extendedprice",
                              "l_discount", "l_shipdate"])
    li = li.filter(pc.greater(li["l_shipdate"], date(1995, 3, 15)))
    oc = join(o, c.select(["c_custkey"]), "o_custkey", "c_custkey")
    j = join(li, oc, "l_orderkey", "o_orderkey")
    keys = ["l_orderkey", "o_orderdate", "o_shippriority"]
    t = pa.table({**{k: j[k] for k in keys}, "rev": revenue(j)})
    g = t.group_by(keys).aggregate([("rev", "sum")]).sort_by([
        ("rev_sum", "descending"), ("o_orderdate", "ascending"),
        ("l_orderkey", "ascending")]).slice(0, 10)
    return [g["l_orderkey"], g["rev_sum"], g["o_orderdate"],
            g["o_shippriority"]]
