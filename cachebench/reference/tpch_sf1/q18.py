"""TPC-H q18: large volume customers (sum(l_quantity) > 300, the
specification's validation value)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import join, sort

#: o_totalprice, o_orderdate (columns 4, 3) may tie under LIMIT 100
CUT = ((4, 3), 0, 100)


def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_orderkey", "l_quantity"])
    per = li.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = per.filter(pc.greater(per["l_quantity_sum"], 300))["l_orderkey"]
    o = db.read("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                           "o_totalprice"])
    o = join(o.filter(pc.is_in(o["o_orderkey"], value_set=big)),
             db.read("customer", ["c_custkey", "c_name"]),
             "o_custkey", "c_custkey")
    j = join(li, o, "l_orderkey", "o_orderkey")
    keys = ["c_name", "o_custkey", "l_orderkey", "o_orderdate",
            "o_totalprice"]
    g = sort(j.group_by(keys).aggregate([("l_quantity", "sum")]),
             [("o_totalprice", "descending"), ("o_orderdate", "ascending")])
    return [g[k] for k in keys] + [g["l_quantity_sum"]]
