"""TPC-H q22: global sales opportunity."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY

def answer(db) -> List[pa.Array]:
    codes = pa.array(["13", "31", "23", "29", "30", "18", "17"])
    c = db.read("customer", ["c_custkey", "c_phone", "c_acctbal"])
    code = pc.utf8_slice_codeunits(c["c_phone"], 0, 2)
    c = c.append_column("cntrycode", code).filter(
        pc.is_in(code, value_set=codes))
    avg = pc.mean(c.filter(pc.greater(c["c_acctbal"], 0.0))["c_acctbal"]
                  ).as_py()
    buyers = pc.unique(db.read("orders", ["o_custkey"])["o_custkey"])
    c = c.filter(pc.and_(pc.greater(c["c_acctbal"], avg),
                         pc.invert(pc.is_in(c["c_custkey"],
                                            value_set=buyers))))
    g = c.group_by("cntrycode").aggregate([
        ("c_custkey", "count", EVERY), ("c_acctbal", "sum")]
    ).sort_by("cntrycode")
    return [g["cntrycode"], g["c_custkey_count"], g["c_acctbal_sum"]]
