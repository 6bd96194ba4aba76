"""TPC-H q9: product type profit for parts named %green%."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import join, revenue, sort

def answer(db) -> List[pa.Array]:
    p = db.read("part", ["p_partkey", "p_name"])
    p = p.filter(pc.match_like(p["p_name"], "%green%"))
    li = db.read("lineitem", ["l_orderkey", "l_partkey", "l_suppkey",
                              "l_quantity", "l_extendedprice",
                              "l_discount"])
    ps = db.read("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    j = join(li, p.select(["p_partkey"]), "l_partkey", "p_partkey")
    j = j.join(ps, ["l_partkey", "l_suppkey"], ["ps_partkey", "ps_suppkey"],
               join_type="inner")
    s = join(db.read("supplier", ["s_suppkey", "s_nationkey"]),
             db.read("nation", ["n_nationkey", "n_name"]),
             "s_nationkey", "n_nationkey")
    j = join(join(j, s, "l_suppkey", "s_suppkey"),
             db.read("orders", ["o_orderkey", "o_orderdate"]),
             "l_orderkey", "o_orderkey")
    amount = pc.subtract(revenue(j), pc.multiply(j["ps_supplycost"],
                                                 j["l_quantity"]))
    t = pa.table({"nation": j["n_name"], "o_year": pc.year(j["o_orderdate"]),
                  "a": amount})
    g = sort(t.group_by(["nation", "o_year"]).aggregate([("a", "sum")]),
             [("nation", "ascending"), ("o_year", "descending")])
    return [g["nation"], g["o_year"], g["a_sum"]]
