"""TPC-DS q97: (customer, item) pairs of 2000 bought in store only, in
catalog only and in both: a full outer join of two grouped CTEs."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import month_seq, semi

KEYS = ["customer_sk", "item_sk"]


def _pairs(db, fact: str, pfx: str) -> pa.Table:
    f = semi(db.read(fact, [f"{pfx}_sold_date_sk", f"{pfx}_customer_sk",
                            f"{pfx}_item_sk"]),
             f"{pfx}_sold_date_sk", month_seq(db, 24, 35), "d_date_sk")
    g = f.group_by([f"{pfx}_customer_sk", f"{pfx}_item_sk"],
                   use_threads=False).aggregate([])
    return g.select([f"{pfx}_customer_sk", f"{pfx}_item_sk"]) \
        .rename_columns(KEYS)


def answer(db) -> List[pa.Array]:
    ss, cs = _pairs(db, "store_sales", "ss"), _pairs(db, "catalog_sales",
                                                     "cs")
    both = ss.join(cs, KEYS, join_type="left semi").num_rows
    return [pa.array([ss.num_rows - both], pa.int64()),
            pa.array([cs.num_rows - both], pa.int64()),
            pa.array([both], pa.int64())]
