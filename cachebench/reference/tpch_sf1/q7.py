"""TPC-H q7: volume shipped between FRANCE and GERMANY."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import between, date, join, nations, revenue

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_orderkey", "l_suppkey", "l_shipdate",
                              "l_extendedprice", "l_discount"])
    li = li.filter(between(li["l_shipdate"], date(1995, 1, 1),
                           date(1996, 12, 31)))
    s = join(db.read("supplier", ["s_suppkey", "s_nationkey"]),
             nations(db, "n1_"), "s_nationkey", "n1_n_nationkey")
    c = join(db.read("customer", ["c_custkey", "c_nationkey"]),
             nations(db, "n2_"), "c_nationkey", "n2_n_nationkey")
    o = join(db.read("orders", ["o_orderkey", "o_custkey"]), c,
             "o_custkey", "c_custkey")
    j = join(join(li, s, "l_suppkey", "s_suppkey"), o, "l_orderkey",
             "o_orderkey")
    sn, cn = j["n1_n_name"], j["n2_n_name"]
    j = j.filter(pc.or_(
        pc.and_(pc.equal(sn, "FRANCE"), pc.equal(cn, "GERMANY")),
        pc.and_(pc.equal(sn, "GERMANY"), pc.equal(cn, "FRANCE"))))
    t = pa.table({"supp_nation": j["n1_n_name"],
                  "cust_nation": j["n2_n_name"],
                  "l_year": pc.year(j["l_shipdate"]), "v": revenue(j)})
    keys = ["supp_nation", "cust_nation", "l_year"]
    g = t.group_by(keys).aggregate([("v", "sum")]).sort_by(
        [(k, "ascending") for k in keys])
    return [g[k] for k in keys] + [g["v_sum"]]
