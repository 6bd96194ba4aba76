"""TPC-DS q20: catalog revenue of Sports, Books and Home items over
30 days, with each item's share of its class (a window over a group-by)."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import item_revenue, item_revenue_columns

#: the order keys (columns 2, 3, 0, 1, 6) may tie under LIMIT 100
CUT = ((2, 3, 0, 1, 6), 0, 100)


def answer(db) -> List[pa.Array]:
    return item_revenue_columns(item_revenue(db, "catalog_sales", "cs"))
