"""TPC-DS q27: ROLLUP(i_item_id, s_state) with grouping() over a
five-table star join: single male college customers' store purchases in
2002."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import join, order, rollup, semi, year_moy

#: i_item_id, s_state (columns 0, 1) under LIMIT 100
CUT = ((0, 1), 0, 100)
STATES = ["AL", "CA", "GA", "IL", "IN", "KS"]


def answer(db) -> List[pa.Array]:
    cd = db.read("customer_demographics", [
        "cd_demo_sk", "cd_gender", "cd_marital_status",
        "cd_education_status"])
    cd = cd.filter(pc.and_(pc.and_(
        pc.equal(cd["cd_gender"], "M"),
        pc.equal(cd["cd_marital_status"], "S")),
        pc.equal(cd["cd_education_status"], "College")))
    st = db.read("store", ["s_store_sk", "s_state"])
    st = st.filter(pc.is_in(st["s_state"], value_set=pa.array(STATES)))
    aggs = [(c, "mean") for c in ("ss_quantity", "ss_list_price",
                                  "ss_coupon_amt", "ss_sales_price")]
    ss = db.read("store_sales", ["ss_sold_date_sk", "ss_item_sk",
                                 "ss_store_sk", "ss_cdemo_sk"]
                 + [c for c, _ in aggs])
    ss = semi(semi(ss, "ss_cdemo_sk", cd, "cd_demo_sk"),
              "ss_sold_date_sk", year_moy(db, 2002), "d_date_sk")
    j = join(join(ss, st, "ss_store_sk", "s_store_sk"),
             db.read("item", ["i_item_sk", "i_item_id"]),
             "ss_item_sk", "i_item_sk")
    g = rollup(j, ["i_item_id", "s_state"], aggs)
    g = order(g, [("i_item_id", False, True), ("s_state", False, True)])
    g_state = pc.cast(pc.greater_equal(g["__level"], 1), pa.int64())
    return [g["i_item_id"], g["s_state"], g_state] + [
        g[f"{c}_mean"] for c, _ in aggs]
