"""TPC-DS q51: each item's running web and store sales by day over four
months (running sums in a ROWS frame in two CTEs), a full outer join of
the two, and the running maxes over it (NULLs skipped, as SQL's max)."""
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import (
    join, month_seq, order, segments, semi)

#: item_sk, d_date (columns 0, 1) under LIMIT 100
CUT = ((0, 1), 0, 100)


def _cume_sales(db, fact: str, pfx: str) -> pa.Table:
    """Each item's running sum of its daily sales."""
    f = db.read(fact, [f"{pfx}_sold_date_sk", f"{pfx}_item_sk",
                       f"{pfx}_sales_price"])
    f = f.filter(pc.is_valid(f[f"{pfx}_item_sk"]))
    d = month_seq(db, 24, 27, ["d_date"])
    j = join(semi(f, f"{pfx}_sold_date_sk", d, "d_date_sk"), d,
             f"{pfx}_sold_date_sk", "d_date_sk")
    g = j.group_by([f"{pfx}_item_sk", "d_date"], use_threads=False) \
        .aggregate([(f"{pfx}_sales_price", "sum")])
    g = order(g, [(f"{pfx}_item_sk", False, False),
                  ("d_date", False, False)])
    v = g[f"{pfx}_sales_price_sum"].to_numpy(zero_copy_only=False)
    cume = np.empty_like(v)
    for a, b in segments(g[f"{pfx}_item_sk"].to_numpy()):
        cume[a:b] = np.cumsum(v[a:b])
    return pa.table({"item_sk": g[f"{pfx}_item_sk"], "d_date": g["d_date"],
                     "cume_sales": cume})


def answer(db) -> List[pa.Array]:
    web = _cume_sales(db, "web_sales", "ws").rename_columns(
        ["item_sk", "d_date", "web_sales"])
    store = _cume_sales(db, "store_sales", "ss").rename_columns(
        ["item_sk", "d_date", "store_sales"])
    m = web.join(store, ["item_sk", "d_date"], join_type="full outer")
    m = order(m, [("item_sk", False, False), ("d_date", False, False)])
    items = m["item_sk"].to_numpy()
    cols = {}
    for c in ("web_sales", "store_sales"):
        v = m[c].to_numpy(zero_copy_only=False).astype(np.float64)
        run = np.empty_like(v)
        for a, b in segments(items):
            run[a:b] = np.fmax.accumulate(v[a:b])
        cols[c] = pa.array(run, mask=np.isnan(run))
    keep = pc.fill_null(pc.greater(cols["web_sales"], cols["store_sales"]),
                        False)
    m = m.filter(keep)
    return [m["item_sk"], m["d_date"], m["web_sales"], m["store_sales"],
            cols["web_sales"].filter(keep), cols["store_sales"].filter(keep)]
