"""TPC-DS q98: store revenue of Sports, Books and Home items over
30 days, with each item's share of its class (a window over a group-by)."""
from typing import List

import pyarrow as pa

from cachebench.reference.tpcds_sf1 import item_revenue, item_revenue_columns

#: its whole answer is ordered by a ratio that may tie
CUT = ((2, 3, 0, 1, 6), 0, 1 << 40)


def answer(db) -> List[pa.Array]:
    return item_revenue_columns(item_revenue(db, "store_sales", "ss"))
