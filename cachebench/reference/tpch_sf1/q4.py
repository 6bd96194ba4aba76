"""TPC-H q4: orders with a late line, by priority."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY, date

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_orderkey", "l_commitdate", "l_receiptdate"])
    late = pc.unique(li.filter(pc.less(li["l_commitdate"],
                                       li["l_receiptdate"]))["l_orderkey"])
    o = db.read("orders", ["o_orderkey", "o_orderdate", "o_orderpriority"])
    o = o.filter(pc.and_(pc.and_(
        pc.greater_equal(o["o_orderdate"], date(1993, 7, 1)),
        pc.less(o["o_orderdate"], date(1993, 10, 1))),
        pc.is_in(o["o_orderkey"], value_set=late)))
    g = o.group_by("o_orderpriority").aggregate([
        ("o_orderkey", "count", EVERY)]).sort_by("o_orderpriority")
    return [g["o_orderpriority"], g["o_orderkey_count"]]
