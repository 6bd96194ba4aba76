"""TPC-DS q71: one manager's brands' November 1999 sales at breakfast and
dinner time by minute, over a UNION ALL of the three channels."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import join, order, semi, year_moy

#: ext_price, brand_id, t_hour, t_minute (columns 4, 0, 2, 3) may tie
CUT = ((4, 0, 2, 3), 0, 1 << 40)


def answer(db) -> List[pa.Array]:
    days = year_moy(db, 1999, 11)
    parts = []
    for fact, pfx in (("web_sales", "ws"), ("catalog_sales", "cs"),
                      ("store_sales", "ss")):
        f = semi(db.read(fact, [f"{pfx}_sold_date_sk", f"{pfx}_item_sk",
                                f"{pfx}_sold_time_sk",
                                f"{pfx}_ext_sales_price"]),
                 f"{pfx}_sold_date_sk", days, "d_date_sk")
        parts.append(pa.table({"ext_price": f[f"{pfx}_ext_sales_price"],
                               "sold_item_sk": f[f"{pfx}_item_sk"],
                               "time_sk": f[f"{pfx}_sold_time_sk"]}))
    u = pa.concat_tables(parts)
    it = db.read("item", ["i_item_sk", "i_brand_id", "i_brand",
                          "i_manager_id"])
    it = it.filter(pc.equal(it["i_manager_id"], 1)).select(
        ["i_item_sk", "i_brand_id", "i_brand"])
    t = db.read("time_dim", ["t_time_sk", "t_hour", "t_minute",
                             "t_meal_time"])
    t = t.filter(pc.fill_null(pc.is_in(t["t_meal_time"], value_set=pa.array(
        ["breakfast", "dinner"])), False)).select(
        ["t_time_sk", "t_hour", "t_minute"])
    j = join(join(u, it, "sold_item_sk", "i_item_sk"), t, "time_sk",
             "t_time_sk")
    g = j.group_by(["i_brand", "i_brand_id", "t_hour", "t_minute"],
                   use_threads=False).aggregate([("ext_price", "sum")])
    g = order(g, [("ext_price_sum", True, False), ("i_brand_id", False, False),
                  ("t_hour", False, False), ("t_minute", False, False)])
    return [g["i_brand_id"], g["i_brand"], g["t_hour"], g["t_minute"],
            g["ext_price_sum"]]
