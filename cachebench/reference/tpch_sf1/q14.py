"""TPC-H q14: promotion effect."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date, join, revenue

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_partkey", "l_extendedprice",
                              "l_discount", "l_shipdate"])
    li = li.filter(pc.and_(
        pc.greater_equal(li["l_shipdate"], date(1995, 9, 1)),
        pc.less(li["l_shipdate"], date(1995, 10, 1))))
    j = join(li, db.read("part", ["p_partkey", "p_type"]),
             "l_partkey", "p_partkey")
    rev = revenue(j)
    promo = pc.sum(pc.if_else(pc.starts_with(j["p_type"], "PROMO"), rev,
                              0.0)).as_py()
    return [pa.array([100.0 * promo / pc.sum(rev).as_py()], pa.float64())]
