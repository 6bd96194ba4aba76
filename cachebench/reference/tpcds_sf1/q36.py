"""TPC-DS q36: gross margin by ROLLUP(i_category, i_class) over 2001's
store sales, ranked within each parent (a window over grouping sets)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import (
    join, rank_in_parent, rollup, semi, year_moy)

#: lochierarchy, i_category, rank (columns 3, 1, 4) under LIMIT 100
CUT = ((3, 1, 4), 0, 100)
STATES = ["AL", "CA", "GA", "IL", "IN", "KS"]


def answer(db) -> List[pa.Array]:
    st = db.read("store", ["s_store_sk", "s_state"])
    st = st.filter(pc.is_in(st["s_state"], value_set=pa.array(STATES)))
    ss = db.read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                 "ss_store_sk", "ss_net_profit",
                                 "ss_ext_sales_price"])
    ss = semi(semi(ss, "ss_sold_date_sk", year_moy(db, 2001), "d_date_sk"),
              "ss_store_sk", st, "s_store_sk")
    j = join(ss, db.read("item", ["i_item_sk", "i_category", "i_class"]),
             "ss_item_sk", "i_item_sk")
    g = rollup(j, ["i_category", "i_class"], [("ss_net_profit", "sum"),
                                             ("ss_ext_sales_price", "sum")])
    g = g.append_column("gross_margin", pc.divide(
        g["ss_net_profit_sum"], g["ss_ext_sales_price_sum"]))
    g = rank_in_parent(g, "gross_margin", desc=False)
    return [g["gross_margin"], g["i_category"], g["i_class"], g["__level"],
            g["rank_within_parent"]]
