"""TPC-H q6: forecast revenue change; the discount bounds are the float sums
0.06 - 0.01 and 0.06 + 0.01 (0.0699...: 0.07 is out)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", [
        "l_extendedprice", "l_discount", "l_shipdate", "l_quantity"])
    m = pc.and_(
        pc.and_(pc.greater_equal(li["l_shipdate"], date(1994, 1, 1)),
                pc.less(li["l_shipdate"], date(1995, 1, 1))),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], 0.06 - 0.01),
                        pc.less_equal(li["l_discount"], 0.06 + 0.01)),
                pc.less(li["l_quantity"], 24)))
    f = li.filter(m)
    rev = pc.sum(pc.multiply(f["l_extendedprice"], f["l_discount"])).as_py()
    return [pa.array([rev], pa.float64())]
