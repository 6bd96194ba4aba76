"""TPC-DS q18: catalog sales averages by ROLLUP(i_item_id, ca_country,
ca_state, ca_county) over a seven-table join that reads
customer_demographics twice (five grouping sets)."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import join, order, rollup, semi, year_moy

#: country, state, county, item (columns 1, 2, 3, 0) under LIMIT 100
CUT = ((1, 2, 3, 0), 0, 100)
STATES = ["MS", "IN", "ND", "OK", "NM", "VA", "MI"]


def answer(db) -> List[pa.Array]:
    cd1 = db.read("customer_demographics", [
        "cd_demo_sk", "cd_gender", "cd_education_status", "cd_dep_count"])
    cd1 = cd1.filter(pc.and_(
        pc.equal(cd1["cd_gender"], "F"),
        pc.equal(cd1["cd_education_status"], "Unknown"))).select(
        ["cd_demo_sk", "cd_dep_count"])
    c = db.read("customer", ["c_customer_sk", "c_current_cdemo_sk",
                             "c_current_addr_sk", "c_birth_month",
                             "c_birth_year"])
    c = c.filter(pc.is_in(c["c_birth_month"], value_set=pa.array(
        [1, 6, 8, 9, 12, 2])))
    c = semi(c, "c_current_cdemo_sk",
             db.read("customer_demographics", ["cd_demo_sk"]), "cd_demo_sk")
    ca = db.read("customer_address", ["ca_address_sk", "ca_country",
                                      "ca_state", "ca_county"])
    ca = ca.filter(pc.is_in(ca["ca_state"], value_set=pa.array(STATES)))
    aggs = ["cs_quantity", "cs_list_price", "cs_coupon_amt",
            "cs_sales_price", "cs_net_profit"]
    cs = db.read("catalog_sales", ["cs_sold_date_sk", "cs_item_sk",
                                   "cs_cdemo_sk", "cs_customer_sk"] + aggs)
    cs = semi(cs, "cs_sold_date_sk", year_moy(db, 1998), "d_date_sk")
    j = join(cs, cd1, "cs_cdemo_sk", "cd_demo_sk")
    j = join(j, c, "cs_customer_sk", "c_customer_sk")
    j = join(j, ca, "c_current_addr_sk", "ca_address_sk")
    j = join(j, db.read("item", ["i_item_sk", "i_item_id"]),
             "cs_item_sk", "i_item_sk")
    keys = ["i_item_id", "ca_country", "ca_state", "ca_county"]
    means = [(a, "mean") for a in aggs + ["c_birth_year", "cd_dep_count"]]
    g = rollup(j, keys, means)
    g = order(g, [("ca_country", False, True), ("ca_state", False, True),
                  ("ca_county", False, True), ("i_item_id", False, True)])
    return [g[k] for k in keys] + [g[f"{a}_mean"] for a, _ in means]
