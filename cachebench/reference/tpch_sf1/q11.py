"""TPC-H q11: important stock in GERMANY; the whole answer is ordered by a
value that may tie."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import join

#: order key `value` (column 1) may tie over the whole answer
CUT = ((1,), 0, 1 << 40)


def answer(db) -> List[pa.Array]:
    n = db.read("nation", ["n_nationkey", "n_name"])
    n = n.filter(pc.equal(n["n_name"], "GERMANY"))
    s = join(db.read("supplier", ["s_suppkey", "s_nationkey"]),
             n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    ps = join(db.read("partsupp", ["ps_partkey", "ps_suppkey",
                                   "ps_supplycost", "ps_availqty"]),
              s.select(["s_suppkey"]), "ps_suppkey", "s_suppkey")
    v = pc.multiply(ps["ps_supplycost"], ps["ps_availqty"])
    # no rows: the HAVING bound is NULL and so is every group
    total = (pc.sum(v).as_py() or 0.0) * 0.0001
    g = pa.table({"ps_partkey": ps["ps_partkey"], "v": v}).group_by(
        "ps_partkey").aggregate([("v", "sum")])
    g = g.filter(pc.greater(g["v_sum"], total)).sort_by(
        [("v_sum", "descending")])
    return [g["ps_partkey"], g["v_sum"]]
