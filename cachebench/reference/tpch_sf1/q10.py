"""TPC-H q10: returned item reporting (ties broken by c_custkey)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.common import date, join, revenue

def answer(db) -> List[pa.Array]:
    o = db.read("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    o = o.filter(pc.and_(
        pc.greater_equal(o["o_orderdate"], date(1993, 10, 1)),
        pc.less(o["o_orderdate"], date(1994, 1, 1))))
    li = db.read("lineitem", ["l_orderkey", "l_extendedprice",
                              "l_discount", "l_returnflag"])
    li = li.filter(pc.equal(li["l_returnflag"], "R"))
    c = join(db.read("customer", [
        "c_custkey", "c_name", "c_acctbal", "c_phone", "c_address",
        "c_comment", "c_nationkey"]), db.read("nation", [
            "n_nationkey", "n_name"]), "c_nationkey", "n_nationkey")
    j = join(join(li, o.select(["o_orderkey", "o_custkey"]), "l_orderkey",
                  "o_orderkey"), c, "o_custkey", "c_custkey")
    keys = ["o_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
            "c_address", "c_comment"]
    t = pa.table({**{k: j[k] for k in keys}, "rev": revenue(j)})
    g = t.group_by(keys).aggregate([("rev", "sum")]).sort_by([
        ("rev_sum", "descending"), ("o_custkey", "ascending")]).slice(0, 20)
    return [g["o_custkey"], g["c_name"], g["rev_sum"], g["c_acctbal"],
            g["n_name"], g["c_address"], g["c_phone"], g["c_comment"]]
