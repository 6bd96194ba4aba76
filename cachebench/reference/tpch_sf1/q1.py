"""TPC-H q1: the pricing summary report."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY, date

def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", [
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate"])
    f = li.filter(pc.less_equal(li["l_shipdate"], date(1998, 9, 2)))
    disc = pc.multiply(f["l_extendedprice"], pc.subtract(1.0, f["l_discount"]))
    t = pa.table({
        "rf": f["l_returnflag"], "ls": f["l_linestatus"],
        "qty": f["l_quantity"], "price": f["l_extendedprice"],
        "disc_price": disc,
        "charge": pc.multiply(disc, pc.add(1.0, f["l_tax"])),
        "disc": f["l_discount"]})
    g = t.group_by(["rf", "ls"]).aggregate([
        ("qty", "sum"), ("price", "sum"), ("disc_price", "sum"),
        ("charge", "sum"), ("qty", "mean"), ("price", "mean"),
        ("disc", "mean"), ("qty", "count", EVERY)]).sort_by([
            ("rf", "ascending"), ("ls", "ascending")])
    return [g["rf"], g["ls"], g["qty_sum"], g["price_sum"],
            g["disc_price_sum"], g["charge_sum"], g["qty_mean"],
            g["price_mean"], g["disc_mean"], g["qty_count"]]
