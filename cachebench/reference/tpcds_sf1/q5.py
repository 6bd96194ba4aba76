"""TPC-DS q5: each channel's sales, returns and profit by store, catalog
page and web site over 15 days, from a UNION ALL of sales and returns in
three CTEs, then ROLLUP(channel, id) over their UNION ALL."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import (
    date_sks, days, join, order, rollup, semi)

#: channel, id (columns 0, 1) under LIMIT 100
CUT = ((0, 1), 0, 100)
COLS = ["k", "d", "sales_price", "profit", "return_amt", "net_loss"]


def _part(t: pa.Table, names: List[str], zeros: List[str]) -> pa.Table:
    """`t`'s columns `names` as (k, d, ...) with the `zeros` columns 0.0."""
    cols = dict(zip([c for c in COLS if c not in zeros], names))
    n = t.num_rows
    return pa.table({c: (t[cols[c]] if c in cols else
                         pa.array([0.0] * n, t[names[-1]].type))
                     for c in COLS})


def _channel(db, sales: pa.Table, rets: pa.Table, dim: str, dim_sk: str,
             dim_id: str, prefix: str, channel: str) -> pa.Table:
    window = date_sks(db, *days(2000, 8, 23, 14))
    u = pa.concat_tables([
        _part(sales, list(sales.column_names), ["return_amt", "net_loss"]),
        _part(rets, list(rets.column_names), ["sales_price", "profit"])])
    u = join(semi(u, "d", window, "d_date_sk"),
             db.read(dim, [dim_sk, dim_id]), "k", dim_sk)
    g = u.group_by(dim_id, use_threads=False).aggregate([
        ("sales_price", "sum"), ("profit", "sum"), ("return_amt", "sum"),
        ("net_loss", "sum")])
    return pa.table({
        "channel": pa.array([channel] * g.num_rows),
        "id": pc.binary_join_element_wise(prefix, g[dim_id], ""),
        "sales": g["sales_price_sum"],
        "returns_amt": g["return_amt_sum"],
        "profit": pc.subtract(g["profit_sum"], g["net_loss_sum"])})


def answer(db) -> List[pa.Array]:
    ss = db.read("store_sales", ["ss_store_sk", "ss_sold_date_sk",
                                 "ss_ext_sales_price", "ss_net_profit"])
    sr = db.read("store_returns", ["sr_store_sk", "sr_returned_date_sk",
                                   "sr_return_amt", "sr_net_loss"])
    cs = db.read("catalog_sales", ["cs_catalog_page_sk", "cs_sold_date_sk",
                                   "cs_ext_sales_price", "cs_net_profit"])
    cr = db.read("catalog_returns", ["cr_catalog_page_sk",
                                     "cr_returned_date_sk",
                                     "cr_return_amount", "cr_net_loss"])
    ws = db.read("web_sales", ["ws_web_site_sk", "ws_sold_date_sk",
                               "ws_ext_sales_price", "ws_net_profit",
                               "ws_item_sk", "ws_order_number"])
    wr = db.read("web_returns", ["wr_item_sk", "wr_order_number",
                                 "wr_returned_date_sk", "wr_return_amt",
                                 "wr_net_loss"])
    # a web return takes the site of the sale line it returns
    wr = wr.join(ws.select(["ws_item_sk", "ws_order_number",
                            "ws_web_site_sk"]),
                 ["wr_item_sk", "wr_order_number"],
                 ["ws_item_sk", "ws_order_number"], join_type="left outer")
    x = pa.concat_tables([
        _channel(db, ss, sr, "store", "s_store_sk", "s_store_id", "store",
                 "store channel"),
        _channel(db, cs, cr, "catalog_page", "cp_catalog_page_sk",
                 "cp_catalog_page_id", "catalog_page", "catalog channel"),
        _channel(db, ws.select(["ws_web_site_sk", "ws_sold_date_sk",
                                "ws_ext_sales_price", "ws_net_profit"]),
                 wr.select(["ws_web_site_sk", "wr_returned_date_sk",
                            "wr_return_amt", "wr_net_loss"]),
                 "web_site", "web_site_sk", "web_site_id", "web_site",
                 "web channel")])
    g = rollup(x, ["channel", "id"], [("sales", "sum"),
                                     ("returns_amt", "sum"),
                                     ("profit", "sum")])
    g = order(g, [("channel", False, False), ("id", False, False)])
    return [g["channel"], g["id"], g["sales_sum"], g["returns_amt_sum"],
            g["profit_sum"]]
