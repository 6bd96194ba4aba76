"""TPC-DS q77: each channel's sales, returns and profit over 31 days by
store, call center and web page, from six CTEs and three LEFT JOINs, then
ROLLUP(channel, id) over their UNION ALL."""
from typing import List

import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import (
    date_sks, days, order, rollup, semi)

#: channel, id, sales (columns 0, 1, 2) under LIMIT 100
CUT = ((0, 1, 2), 0, 100)


def _sums(db, table: str, date: str, key: str, a: str, b: str,
          names, dim=None) -> pa.Table:
    """`table`'s rows of the 31 days (and of the dimension `dim`'s keys)
    summed by `key`: a, b as `names`."""
    t = semi(db.read(table, [date, key, a, b]), date,
             date_sks(db, *days(2000, 8, 3, 30)), "d_date_sk")
    if dim is not None:
        t = semi(t, key, db.read(dim[0], [dim[1]]), dim[1])
    g = t.group_by(key, use_threads=False).aggregate([(a, "sum"),
                                                      (b, "sum")])
    return pa.table({"id": g[key], names[0]: g[f"{a}_sum"],
                     names[1]: g[f"{b}_sum"]})


def _channel(name: str, sales: pa.Table, rets: pa.Table) -> pa.Table:
    j = sales.join(rets, "id", join_type="left outer")
    returns_amt = pc.fill_null(j["returns_amt"], 0.0)
    return pa.table({
        "channel": pa.array([name] * j.num_rows), "id": j["id"],
        "sales": j["sales"], "returns_amt": returns_amt,
        "profit": pc.subtract(j["profit"],
                              pc.fill_null(j["profit_loss"], 0.0))})


def answer(db) -> List[pa.Array]:
    s, r = ("sales", "profit"), ("returns_amt", "profit_loss")
    store = ("store", "s_store_sk")
    page = ("web_page", "wp_web_page_sk")
    x = pa.concat_tables([
        _channel("store channel",
                 _sums(db, "store_sales", "ss_sold_date_sk", "ss_store_sk",
                       "ss_ext_sales_price", "ss_net_profit", s, store),
                 _sums(db, "store_returns", "sr_returned_date_sk",
                       "sr_store_sk", "sr_return_amt", "sr_net_loss", r,
                       store)),
        _channel("catalog channel",
                 _sums(db, "catalog_sales", "cs_sold_date_sk",
                       "cs_call_center_sk", "cs_ext_sales_price",
                       "cs_net_profit", s),
                 _sums(db, "catalog_returns", "cr_returned_date_sk",
                       "cr_call_center_sk", "cr_return_amount",
                       "cr_net_loss", r)),
        _channel("web channel",
                 _sums(db, "web_sales", "ws_sold_date_sk", "ws_web_page_sk",
                       "ws_ext_sales_price", "ws_net_profit", s, page),
                 _sums(db, "web_returns", "wr_returned_date_sk",
                       "wr_web_page_sk", "wr_return_amt", "wr_net_loss", r,
                       page))])
    g = rollup(x, ["channel", "id"], [("sales", "sum"),
                                     ("returns_amt", "sum"),
                                     ("profit", "sum")])
    g = order(g, [("channel", False, True), ("id", False, True),
                  ("sales_sum", False, False)])
    return [g["channel"], g["id"], g["sales_sum"], g["returns_amt_sum"],
            g["profit_sum"]]
