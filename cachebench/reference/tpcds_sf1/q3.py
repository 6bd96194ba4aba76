"""TPC-DS q3: a brand's November store sales by year, of one
manufacturer's items."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import join, order, semi

#: d_year, sum_agg, brand_id (columns 0, 3, 1) may tie under LIMIT 100
CUT = ((0, 3, 1), 0, 100)


def answer(db) -> List[pa.Array]:
    d = db.read("date_dim", ["d_date_sk", "d_year", "d_moy"])
    d = d.filter(pc.equal(d["d_moy"], 11)).select(["d_date_sk", "d_year"])
    it = db.read("item", ["i_item_sk", "i_brand_id", "i_brand",
                          "i_manufact_id"])
    it = it.filter(pc.equal(it["i_manufact_id"], 128))
    ss = semi(db.read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                      "ss_ext_sales_price"]),
              "ss_item_sk", it, "i_item_sk")
    j = join(join(ss, d, "ss_sold_date_sk", "d_date_sk"),
             it.select(["i_item_sk", "i_brand_id", "i_brand"]),
             "ss_item_sk", "i_item_sk")
    keys = ["d_year", "i_brand_id", "i_brand"]
    g = j.group_by(keys, use_threads=False).aggregate(
        [("ss_ext_sales_price", "sum")])
    g = order(g, [("d_year", False, False),
                  ("ss_ext_sales_price_sum", True, False),
                  ("i_brand_id", False, False)])
    return [g["d_year"], g["i_brand_id"], g["i_brand"],
            g["ss_ext_sales_price_sum"]]
