"""TPC-H q16: parts/supplier relationship."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import join, sort

def answer(db) -> List[pa.Array]:
    s = db.read("supplier", ["s_suppkey", "s_comment"])
    bad = s.filter(pc.match_like(s["s_comment"],
                                 "%Customer%Complaints%"))["s_suppkey"]
    p = db.read("part", ["p_partkey", "p_brand", "p_type", "p_size"])
    p = p.filter(pc.and_(pc.and_(
        pc.not_equal(p["p_brand"], "Brand#45"),
        pc.invert(pc.match_like(p["p_type"], "MEDIUM POLISHED%"))),
        pc.is_in(p["p_size"], value_set=pa.array(
            [49, 14, 23, 45, 19, 3, 36, 9], p["p_size"].type))))
    ps = db.read("partsupp", ["ps_partkey", "ps_suppkey"])
    ps = ps.filter(pc.invert(pc.is_in(ps["ps_suppkey"], value_set=bad)))
    j = join(ps, p, "ps_partkey", "p_partkey")
    keys = ["p_brand", "p_type", "p_size"]
    g = j.group_by(keys).aggregate([("ps_suppkey", "count_distinct")])
    g = sort(g, [("ps_suppkey_count_distinct", "descending")]
             + [(k, "ascending") for k in keys])
    return [g[k] for k in keys] + [g["ps_suppkey_count_distinct"]]
