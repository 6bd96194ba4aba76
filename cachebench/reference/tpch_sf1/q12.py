"""TPC-H q12: shipping modes and order priority."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date, join

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_orderkey", "l_shipmode", "l_shipdate",
                              "l_commitdate", "l_receiptdate"])
    li = li.filter(pc.and_(pc.and_(
        pc.is_in(li["l_shipmode"], pa.array(["MAIL", "SHIP"])),
        pc.and_(pc.less(li["l_commitdate"], li["l_receiptdate"]),
                pc.less(li["l_shipdate"], li["l_commitdate"]))), pc.and_(
        pc.greater_equal(li["l_receiptdate"], date(1994, 1, 1)),
        pc.less(li["l_receiptdate"], date(1995, 1, 1)))))
    j = join(li, db.read("orders", ["o_orderkey", "o_orderpriority"]),
             "l_orderkey", "o_orderkey")
    high = pc.is_in(j["o_orderpriority"], pa.array(["1-URGENT", "2-HIGH"]))
    t = pa.table({"mode": j["l_shipmode"],
                  "high": pc.cast(high, pa.int64()),
                  "low": pc.cast(pc.invert(high), pa.int64())})
    g = t.group_by("mode").aggregate([("high", "sum"), ("low", "sum")]
                                     ).sort_by("mode")
    return [g["mode"], g["high_sum"], g["low_sum"]]
