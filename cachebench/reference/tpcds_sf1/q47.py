"""TPC-DS q47: monthly store sales by category, brand and store in 1999
against their yearly average, with the months before and after: windows
(avg over a partition, rank) in a CTE that the query reads three times."""
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from cachebench.reference.tpcds_sf1 import join, order, run_ids, semi

KEYS = ["i_category", "i_brand", "s_store_name", "s_company_name"]


def answer(db) -> List[pa.Array]:
    d = db.read("date_dim", ["d_date_sk", "d_year", "d_moy"])
    d = d.filter(pc.or_(pc.equal(d["d_year"], 1999), pc.or_(
        pc.and_(pc.equal(d["d_year"], 1998), pc.equal(d["d_moy"], 12)),
        pc.and_(pc.equal(d["d_year"], 2000), pc.equal(d["d_moy"], 1)))))
    ss = semi(db.read("store_sales", ["ss_item_sk", "ss_sold_date_sk",
                                      "ss_store_sk", "ss_sales_price"]),
              "ss_sold_date_sk", d, "d_date_sk")
    j = join(join(join(ss, d, "ss_sold_date_sk", "d_date_sk"),
                  db.read("item", ["i_item_sk", "i_category", "i_brand"]),
                  "ss_item_sk", "i_item_sk"),
             db.read("store", ["s_store_sk", "s_store_name",
                               "s_company_name"]),
             "ss_store_sk", "s_store_sk")
    g = j.group_by(KEYS + ["d_year", "d_moy"], use_threads=False).aggregate(
        [("ss_sales_price", "sum")])
    g = order(g, [(k, False, False) for k in KEYS + ["d_year", "d_moy"]])
    sums = g["ss_sales_price_sum"].to_numpy(zero_copy_only=False)
    # avg(sum) OVER (PARTITION BY the keys and d_year)
    year_run = run_ids(g, KEYS + ["d_year"])
    avg = (np.bincount(year_run, sums) / np.bincount(year_run))[year_run]
    # rank() OVER (PARTITION BY the keys ORDER BY d_year, d_moy): the
    # months of a partition are distinct, so its rows in order; the
    # self-joins on rn - 1 and rn + 1 keep the rows with a row before and
    # after them in their partition, and read those rows' sums
    part = run_ids(g, KEYS)
    n = g.num_rows
    inner = np.zeros(n, bool)
    if n > 2:
        inner[1:-1] = (part[1:-1] == part[:-2]) & (part[1:-1] == part[2:])
    idx = np.flatnonzero(inner)
    avg_t, sum_t = avg[idx], sums[idx]
    t = pa.table({
        "i_category": g["i_category"].take(idx),
        "s_store_name": g["s_store_name"].take(idx),
        "s_company_name": g["s_company_name"].take(idx),
        "d_year": g["d_year"].take(idx), "d_moy": g["d_moy"].take(idx),
        "avg_monthly_sales": pa.array(avg_t),
        "sum_sales": g["ss_sales_price_sum"].take(idx),
        "psum": g["ss_sales_price_sum"].take(idx - 1),
        "nsum": g["ss_sales_price_sum"].take(idx + 1),
        "__diff": pa.array(sum_t - avg_t)})
    keep = pc.and_(pc.and_(pc.equal(t["d_year"], 1999),
                           pc.greater(t["avg_monthly_sales"], 0)),
                   pc.greater(pc.divide(pc.abs(t["__diff"]),
                                        t["avg_monthly_sales"]), 0.1))
    t = order(t.filter(keep), [("__diff", False, False),
                               ("s_store_name", False, False),
                               ("d_moy", False, False)]).slice(0, 100)
    return [t[c] for c in ("i_category", "s_store_name", "s_company_name",
                           "d_year", "d_moy", "avg_monthly_sales",
                           "sum_sales", "psum", "nsum")]
