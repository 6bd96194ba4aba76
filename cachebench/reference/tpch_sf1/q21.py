"""TPC-H q21: suppliers who kept orders waiting, in SAUDI ARABIA."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import EVERY, join, sort

#: numwait, s_name (columns 1, 0) under LIMIT 100
CUT = ((1, 0), 0, 100)


def answer(db) -> List[pa.Array]:
    li = db.read("lineitem", ["l_orderkey", "l_suppkey", "l_receiptdate",
                              "l_commitdate"])
    late = li.filter(pc.greater(li["l_receiptdate"], li["l_commitdate"]))
    # EXISTS another supplier on the order: two or more distinct ones;
    # NOT EXISTS another late one: the late rows name one supplier only
    n_all = li.group_by("l_orderkey").aggregate(
        [("l_suppkey", "count_distinct")]).rename_columns(["k", "n_all"])
    n_late = late.group_by("l_orderkey").aggregate(
        [("l_suppkey", "count_distinct")]).rename_columns(["k", "n_late"])
    keep = join(n_all.filter(pc.greater_equal(n_all["n_all"], 2)),
                n_late.filter(pc.equal(n_late["n_late"], 1)), "k", "k")
    l1 = join(late, keep.select(["k"]), "l_orderkey", "k")
    o = db.read("orders", ["o_orderkey", "o_orderstatus"])
    o = o.filter(pc.equal(o["o_orderstatus"], "F"))
    n = db.read("nation", ["n_nationkey", "n_name"])
    n = n.filter(pc.equal(n["n_name"], "SAUDI ARABIA"))
    s = join(db.read("supplier", ["s_suppkey", "s_name", "s_nationkey"]),
             n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    j = join(join(l1, o.select(["o_orderkey"]), "l_orderkey", "o_orderkey"),
             s, "l_suppkey", "s_suppkey")
    g = sort(j.group_by("s_name").aggregate([("l_suppkey", "count", EVERY)]),
             [("l_suppkey_count", "descending"), ("s_name", "ascending")])
    return [g["s_name"], g["l_suppkey_count"]]
