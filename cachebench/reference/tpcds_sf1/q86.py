"""TPC-DS q86: web net paid by ROLLUP(i_category, i_class) over 2000,
ranked within each parent (a window over grouping sets)."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import (
    join, month_seq, rank_in_parent, rollup, semi)

#: lochierarchy, i_category, rank (columns 3, 1, 4) under LIMIT 100
CUT = ((3, 1, 4), 0, 100)


def answer(db) -> List[pa.Array]:
    ws = db.read("web_sales", ["ws_sold_date_sk", "ws_item_sk",
                               "ws_net_paid"])
    ws = semi(ws, "ws_sold_date_sk", month_seq(db, 24, 35), "d_date_sk")
    j = join(ws, db.read("item", ["i_item_sk", "i_category", "i_class"]),
             "ws_item_sk", "i_item_sk")
    g = rollup(j, ["i_category", "i_class"], [("ws_net_paid", "sum")])
    g = rank_in_parent(g, "ws_net_paid_sum", desc=True)
    return [g["ws_net_paid_sum"], g["i_category"], g["i_class"],
            g["__level"], g["rank_within_parent"]]
