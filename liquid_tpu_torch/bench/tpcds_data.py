"""Deterministic TPC-DS data generator (core-table subset).

Equivalent role to the reference's TPC-DS data (liquid-cache
`benchmark/tpcds/manifest.json` + `tpcds_gen.py` which shells out to
duckdb's dsdgen; unavailable here, so we generate spec-shaped tables
directly).  Covers the 23 tables the 85-query suite touches:
the three sales channels with their returns tables, date/time dims,
item, customer (+address/demographics/household/income_band), store,
warehouse, ship_mode, call_center, web_site, web_page, promotion,
reason, inventory.

Correctness of query answers is verified DIFFERENTIALLY (engine vs
pandas on the same data) plus a dual-path self-check, so official dsdgen
bytes are not required -- deterministic, realistically-distributed data
is.

Host copy of `liquid_tpu/bench/tpcds_data.py`: the port imports nothing of
the reference package.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Men", "Music",
              "Shoes", "Sports", "Children", "Women"]
STATES = ["AL", "CA", "GA", "IL", "IN", "KS", "KY", "MI", "MN", "MO",
          "NC", "NY", "OH", "TN", "TX", "VA", "WA", "WI"]
COUNTIES = [f"{w} County" for w in
            ["Ziebach", "Walker", "Williamson", "Franklin", "Fairfield",
             "Bronx", "Orange", "Daviess", "Barrow", "Luce"]]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
             "Advanced Degree", "Unknown"]
MARITAL = ["M", "S", "D", "W", "U"]
GENDER = ["M", "F"]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]


def _money(rng, n, lo, hi):
    return np.round(rng.uniform(lo, hi, n), 2)


def generate(sf: float = 0.01, seed: int = 20030101) -> Dict[str, pa.Table]:
    rng = np.random.default_rng(seed)
    n_item = max(200, int(18_000 * sf))
    n_cust = max(500, int(100_000 * sf))
    n_store = max(4, int(12 * max(sf, 0.1)))
    # floors keep selective official parameters (manager/moy/year bands)
    # non-empty even at tiny scale factors
    n_ss = max(60_000, int(2_880_000 * sf))
    n_cs = max(30_000, int(1_440_000 * sf))
    n_ws = max(15_000, int(720_000 * sf))
    n_ca = n_cust
    n_cd = 1000
    n_hd = 200

    # date_dim: 1998-01-01 .. 2003-12-31 (dbgen uses 1900..2100; queries
    # live in 1998-2002)
    dates = np.arange(np.datetime64("1998-01-01"), np.datetime64("2004-01-01"))
    nd = len(dates)
    d_sk = np.arange(1, nd + 1)
    d_date = dates.astype("datetime64[D]")
    yy = d_date.astype("datetime64[Y]").astype(int) + 1970
    mm = d_date.astype("datetime64[M]").astype(int) % 12 + 1
    dow = (d_date.astype("datetime64[D]").view("int64") + 4) % 7
    dom = (d_date - d_date.astype("datetime64[M]")).astype(int) + 1
    qoy = (mm - 1) // 3 + 1
    date_dim = pa.table({
        "d_date_sk": pa.array(d_sk, pa.int64()),
        "d_date": pa.array(d_date.astype(object)),
        "d_year": pa.array(yy.astype(np.int64)),
        "d_moy": pa.array(mm.astype(np.int64)),
        "d_dom": pa.array(dom.astype(np.int64)),
        "d_dow": pa.array(dow.astype(np.int64)),
        "d_qoy": pa.array(qoy.astype(np.int64)),
        "d_month_seq": pa.array(((yy - 1998) * 12 + mm - 1).astype(np.int64)),
        "d_week_seq": pa.array(
            ((d_date.view("int64") - d_date.view("int64")[0] + 4) // 7
             ).astype(np.int64)),
        "d_day_name": pa.array(np.array(
            ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"])[dow.astype(int)]),
    })

    time_dim = pa.table({
        "t_time_sk": pa.array(np.arange(86400, dtype=np.int64)),
        "t_time": pa.array(np.arange(86400, dtype=np.int64)),
        "t_hour": pa.array((np.arange(86400) // 3600).astype(np.int64)),
        "t_minute": pa.array((np.arange(86400) % 3600 // 60).astype(np.int64)),
    })
    _th = np.arange(86400) // 3600
    _meal = np.where((_th >= 6) & (_th <= 8), "breakfast",
                     np.where((_th >= 17) & (_th <= 19), "dinner", ""))
    time_dim = time_dim.append_column(
        "t_meal_time", pa.array(_meal.astype(object),
                                mask=(_meal == "")))

    i_cat = rng.choice(CATEGORIES, n_item)
    item = pa.table({
        "i_item_sk": pa.array(np.arange(1, n_item + 1), pa.int64()),
        "i_item_id": pa.array([f"AAAAAAAA{i:08d}" for i in range(1, n_item + 1)]),
        "i_item_desc": pa.array([f"item desc {i}" for i in range(1, n_item + 1)]),
        "i_product_name": pa.array([f"product{i:07d}"
                                    for i in range(1, n_item + 1)]),
        "i_category": pa.array(i_cat),
        "i_class": pa.array([f"{c[:4].lower()}class{rng.integers(1, 8)}"
                             for c in i_cat]),
        "i_brand": pa.array([f"brand#{rng.integers(1, 100)}"
                             for _ in range(n_item)]),
        "i_brand_id": pa.array(rng.integers(1000001, 10016017, n_item), pa.int64()),
        "i_manufact_id": pa.array(
            (np.arange(n_item) % 1000 + 1).astype(np.int64)),
        "i_manager_id": pa.array(
            (np.arange(n_item) % 100 + 1).astype(np.int64)),
        "i_current_price": pa.array(_money(rng, n_item, 0.5, 100.0)),
        "i_wholesale_cost": pa.array(_money(rng, n_item, 0.3, 70.0)),
    })
    # id/color/size columns (q14/q24/q75 shapes); dedicated rng keeps
    # the main stream -- and every pre-existing column -- bit-identical
    ri = np.random.default_rng(seed + 300)
    cat_index = np.array([CATEGORIES.index(c) + 1 for c in i_cat],
                         dtype=np.int64)
    class_no = np.array([int(str(cl).rsplit("class", 1)[1])
                         for cl in item.column("i_class").to_pylist()],
                        dtype=np.int64)
    COLORS = ["red", "blue", "green", "yellow", "purple", "orange",
              "white", "black", "pink", "brown", "cyan", "magenta"]
    SIZES = ["small", "medium", "large", "extra large", "petite", "N/A"]
    UNITS = ["Each", "Dozen", "Case", "Pallet", "Box", "Unknown"]
    item = (item
            .append_column("i_category_id", pa.array(cat_index))
            .append_column("i_class_id",
                           pa.array(cat_index * 10 + class_no))
            .append_column("i_color", pa.array(ri.choice(COLORS, n_item)))
            .append_column("i_size", pa.array(ri.choice(SIZES, n_item)))
            .append_column("i_units", pa.array(ri.choice(UNITS, n_item))))

    customer_address = pa.table({
        "ca_address_sk": pa.array(np.arange(1, n_ca + 1), pa.int64()),
        "ca_state": pa.array(rng.choice(STATES, n_ca)),
        "ca_county": pa.array(rng.choice(COUNTIES, n_ca)),
        "ca_city": pa.array([f"city{rng.integers(1, 200)}" for _ in range(n_ca)]),
        "ca_country": pa.array(np.full(n_ca, "United States")),
        "ca_zip": pa.array([f"{rng.integers(10000, 99999)}" for _ in range(n_ca)]),
        "ca_gmt_offset": pa.array(rng.choice([-5.0, -6.0, -7.0, -8.0], n_ca)),
    })

    customer_demographics = pa.table({
        "cd_demo_sk": pa.array(np.arange(1, n_cd + 1), pa.int64()),
        "cd_gender": pa.array(rng.choice(GENDER, n_cd)),
        "cd_marital_status": pa.array(rng.choice(MARITAL, n_cd)),
        "cd_education_status": pa.array(rng.choice(EDUCATION, n_cd)),
        "cd_credit_rating": pa.array(rng.choice(CREDIT, n_cd)),
        "cd_dep_count": pa.array(rng.integers(0, 7, n_cd), pa.int64()),
    })

    household_demographics = pa.table({
        "hd_demo_sk": pa.array(np.arange(1, n_hd + 1), pa.int64()),
        "hd_income_band_sk": pa.array(
            rng.integers(1, 21, n_hd), pa.int64()),
        "hd_buy_potential": pa.array(rng.choice(BUY_POTENTIAL, n_hd)),
        "hd_dep_count": pa.array(rng.integers(0, 10, n_hd), pa.int64()),
        "hd_vehicle_count": pa.array(rng.integers(-1, 5, n_hd), pa.int64()),
    })

    rc = np.random.default_rng(seed + 55)
    customer = pa.table({
        "c_customer_sk": pa.array(np.arange(1, n_cust + 1), pa.int64()),
        "c_customer_id": pa.array([f"CUST{i:012d}" for i in range(1, n_cust + 1)]),
        "c_first_name": pa.array([f"First{i % 500}" for i in range(n_cust)]),
        "c_last_name": pa.array([f"Last{i % 700}" for i in range(n_cust)]),
        "c_salutation": pa.array(rc.choice(
            ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"], n_cust)),
        "c_preferred_cust_flag": pa.array(rc.choice(["Y", "N"], n_cust)),
        "c_current_addr_sk": pa.array(rng.integers(1, n_ca + 1, n_cust), pa.int64()),
        "c_current_cdemo_sk": pa.array(rng.integers(1, n_cd + 1, n_cust), pa.int64()),
        "c_current_hdemo_sk": pa.array(rng.integers(1, n_hd + 1, n_cust), pa.int64()),
        "c_birth_country": pa.array(rng.choice(
            ["UNITED STATES", "CANADA", "MEXICO", "GERMANY", "JAPAN"], n_cust)),
        "c_birth_year": pa.array(rng.integers(1924, 1993, n_cust), pa.int64()),
        "c_birth_month": pa.array(rng.integers(1, 13, n_cust), pa.int64()),
    })

    store = pa.table({
        "s_store_sk": pa.array(np.arange(1, n_store + 1), pa.int64()),
        "s_store_id": pa.array([f"ST{i:06d}" for i in range(1, n_store + 1)]),
        "s_store_name": pa.array([f"store {chr(96 + i)}"
                                  for i in range(1, n_store + 1)]),
        "s_company_name": pa.array(np.full(n_store, "Unknown")),
        "s_state": pa.array(rng.choice(STATES[:6], n_store)),
        "s_county": pa.array([COUNTIES[i % len(COUNTIES)]
                              for i in range(n_store)]),
        "s_city": pa.array([f"city{i}" for i in range(1, n_store + 1)]),
        "s_number_employees": pa.array(rng.integers(200, 301, n_store), pa.int64()),
        "s_gmt_offset": pa.array(rng.choice([-5.0, -6.0], n_store)),
        "s_zip": pa.array([f"{rng.integers(10000, 99999)}"
                           for _ in range(n_store)]),
    })
    store = store.append_column(
        "s_market_id", pa.array(
            np.random.default_rng(seed + 301).integers(1, 11, n_store),
            pa.int64()))

    def sales(n, prefix, with_store=False, seed_off=0):
        r = np.random.default_rng(seed + 7 + seed_off)
        sold_date = r.integers(1, nd + 1, n)
        qty = r.integers(1, 101, n).astype(np.float64)
        wholesale = _money(r, n, 1.0, 100.0)
        list_price = np.round(wholesale * r.uniform(1.0, 2.5, n), 2)
        sales_price = np.round(list_price * r.uniform(0.2, 1.0, n), 2)
        discount = np.round((list_price - sales_price) * qty, 2)
        ext_sales = np.round(sales_price * qty, 2)
        ext_list = np.round(list_price * qty, 2)
        ext_wholesale = np.round(wholesale * qty, 2)
        coupon = np.where(r.random(n) < 0.1, np.round(ext_sales * 0.1, 2), 0.0)
        net_paid = np.round(ext_sales - coupon, 2)
        net_profit = np.round(net_paid - ext_wholesale, 2)
        cols = {
            f"{prefix}_sold_date_sk": pa.array(sold_date, pa.int64()),
            f"{prefix}_sold_time_sk": pa.array(
                r.integers(0, 86400, n), pa.int64()),
            f"{prefix}_item_sk": pa.array(r.integers(1, n_item + 1, n), pa.int64()),
            f"{prefix}_customer_sk": pa.array(
                r.integers(1, n_cust + 1, n), pa.int64()),
            f"{prefix}_cdemo_sk": pa.array(r.integers(1, n_cd + 1, n), pa.int64()),
            f"{prefix}_hdemo_sk": pa.array(r.integers(1, n_hd + 1, n), pa.int64()),
            f"{prefix}_addr_sk": pa.array(r.integers(1, n_ca + 1, n), pa.int64()),
            f"{prefix}_ticket_number" if prefix == "ss" else
            f"{prefix}_order_number": pa.array(
                np.arange(1, n + 1), pa.int64()),
            f"{prefix}_quantity": pa.array(qty),
            f"{prefix}_wholesale_cost": pa.array(wholesale),
            f"{prefix}_list_price": pa.array(list_price),
            f"{prefix}_sales_price": pa.array(sales_price),
            f"{prefix}_ext_discount_amt": pa.array(discount),
            f"{prefix}_ext_sales_price": pa.array(ext_sales),
            f"{prefix}_ext_list_price": pa.array(ext_list),
            f"{prefix}_ext_wholesale_cost": pa.array(ext_wholesale),
            f"{prefix}_coupon_amt": pa.array(coupon),
            f"{prefix}_net_paid": pa.array(net_paid),
            f"{prefix}_net_profit": pa.array(net_profit),
            f"{prefix}_promo_sk": pa.array(r.integers(1, 31, n), pa.int64()),
        }
        if with_store:
            cols["ss_store_sk"] = pa.array(
                r.integers(1, n_store + 1, n), pa.int64())
        return pa.table(cols)

    n_promo = 30
    promotion = pa.table({
        "p_promo_sk": pa.array(np.arange(1, n_promo + 1), pa.int64()),
        "p_promo_id": pa.array([f"PROMO{i:08d}" for i in range(1, n_promo + 1)]),
        "p_channel_email": pa.array(rng.choice(["Y", "N"], n_promo)),
        "p_channel_event": pa.array(rng.choice(["Y", "N"], n_promo)),
        "p_channel_tv": pa.array(rng.choice(["Y", "N"], n_promo)),
    })

    store_sales = sales(n_ss, "ss", with_store=True)
    catalog_sales = sales(n_cs, "cs", seed_off=1)
    web_sales = sales(n_ws, "ws", seed_off=2)
    # web orders span ~2 lines each (dsdgen ships multi-line orders;
    # q95 requires orders touching >1 warehouse)
    web_sales = web_sales.set_column(
        web_sales.column_names.index("ws_order_number"), "ws_order_number",
        pa.array(np.arange(n_ws) // 2 + 1, pa.int64()))

    # nullable FK columns (dsdgen leaves a few percent of FKs NULL;
    # q76 counts sales with NULL channel keys)
    r76 = np.random.default_rng(seed + 76)
    st = np.asarray(store_sales.column("ss_sold_time_sk"))
    store_sales = store_sales.set_column(
        store_sales.column_names.index("ss_sold_time_sk"),
        "ss_sold_time_sk",
        pa.array(st, pa.int64(), mask=r76.random(n_ss) < 0.04))
    web_sales = web_sales.append_column(
        "ws_ship_customer_sk",
        pa.array(r76.integers(1, n_cust + 1, n_ws), pa.int64(),
                 mask=r76.random(n_ws) < 0.04))
    catalog_sales = catalog_sales.append_column(
        "cs_ship_addr_sk",
        pa.array(r76.integers(1, n_ca + 1, n_cs), pa.int64(),
                 mask=r76.random(n_cs) < 0.04))

    # shipping-side FKs (q16/q62/q94/q99 shapes): ship date trails the
    # sold date by up to ~4 months
    rsh = np.random.default_rng(seed + 77)
    cs_sold = np.asarray(catalog_sales.column("cs_sold_date_sk"))
    catalog_sales = catalog_sales.append_column(
        "cs_ship_date_sk", pa.array(
            np.minimum(cs_sold + rsh.integers(1, 121, n_cs), nd),
            pa.int64()))
    catalog_sales = catalog_sales.append_column(
        "cs_ship_mode_sk", pa.array(rsh.integers(1, 21, n_cs), pa.int64()))
    catalog_sales = catalog_sales.append_column(
        "cs_call_center_sk", pa.array(rsh.integers(1, 5, n_cs), pa.int64()))
    catalog_sales = catalog_sales.append_column(
        "cs_warehouse_sk", pa.array(rsh.integers(1, 6, n_cs), pa.int64()))
    ws_sold = np.asarray(web_sales.column("ws_sold_date_sk"))
    web_sales = web_sales.append_column(
        "ws_ship_date_sk", pa.array(
            np.minimum(ws_sold + rsh.integers(1, 121, n_ws), nd),
            pa.int64()))
    web_sales = web_sales.append_column(
        "ws_ship_mode_sk", pa.array(rsh.integers(1, 21, n_ws), pa.int64()))
    web_sales = web_sales.append_column(
        "ws_web_site_sk", pa.array(rsh.integers(1, 5, n_ws), pa.int64()))
    web_sales = web_sales.append_column(
        "ws_warehouse_sk", pa.array(rsh.integers(1, 6, n_ws), pa.int64()))
    web_sales = web_sales.append_column(
        "ws_web_page_sk", pa.array(rsh.integers(1, 61, n_ws), pa.int64()))
    web_sales = web_sales.append_column(
        "ws_ship_addr_sk", pa.array(
            rsh.integers(1, n_ca + 1, n_ws), pa.int64()))
    n_cp = 100
    catalog_page = pa.table({
        "cp_catalog_page_sk": pa.array(np.arange(1, n_cp + 1), pa.int64()),
        "cp_catalog_page_id": pa.array(
            [f"CPAG{i:08d}" for i in range(1, n_cp + 1)]),
    })
    catalog_sales = catalog_sales.append_column(
        "cs_catalog_page_sk", pa.array(
            np.random.default_rng(seed + 302).integers(1, n_cp + 1, n_cs),
            pa.int64()))

    # store_returns: ~10% of store_sales tickets
    r = np.random.default_rng(seed + 99)
    n_sr = n_ss // 10
    ret_idx = r.choice(n_ss, n_sr, replace=False)
    ss_item = np.asarray(store_sales.column("ss_item_sk"))
    ss_cust = np.asarray(store_sales.column("ss_customer_sk"))
    ss_ticket = np.asarray(store_sales.column("ss_ticket_number"))
    ss_store = np.asarray(store_sales.column("ss_store_sk"))
    r2 = np.random.default_rng(seed + 100)
    store_returns = pa.table({
        "sr_returned_date_sk": pa.array(r.integers(1, nd + 1, n_sr), pa.int64()),
        "sr_item_sk": pa.array(ss_item[ret_idx], pa.int64()),
        "sr_customer_sk": pa.array(ss_cust[ret_idx], pa.int64()),
        "sr_ticket_number": pa.array(ss_ticket[ret_idx], pa.int64()),
        "sr_return_quantity": pa.array(r.integers(1, 50, n_sr), pa.int64()),
        "sr_return_amt": pa.array(_money(r, n_sr, 1.0, 2000.0)),
        "sr_net_loss": pa.array(_money(r2, n_sr, 0.5, 1000.0)),
        "sr_cdemo_sk": pa.array(r2.integers(1, n_cd + 1, n_sr), pa.int64()),
        "sr_reason_sk": pa.array(r2.integers(1, 36, n_sr), pa.int64()),
        "sr_store_sk": pa.array(ss_store[ret_idx], pa.int64()),
    })

    warehouse = pa.table({
        "w_warehouse_sk": pa.array(np.arange(1, 7), pa.int64()),
        "w_warehouse_name": pa.array([f"Warehouse {i}" for i in range(1, 7)]),
        "w_warehouse_sq_ft": pa.array(
            rng.integers(50_000, 1_000_000, 6), pa.int64()),
        "w_state": pa.array(rng.choice(STATES[:6], 6)),
        "w_county": pa.array([COUNTIES[i % len(COUNTIES)] for i in range(6)]),
        "w_city": pa.array([f"city{i}" for i in range(1, 7)]),
        "w_country": pa.array(np.full(6, "United States")),
    })

    SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY"]
    ship_mode = pa.table({
        "sm_ship_mode_sk": pa.array(np.arange(1, 21), pa.int64()),
        "sm_ship_mode_id": pa.array([f"SM{i:04d}" for i in range(1, 21)]),
        "sm_type": pa.array([SHIP_TYPES[i % 5] for i in range(20)]),
        "sm_carrier": pa.array([f"CARRIER{i % 7}" for i in range(20)]),
        "sm_code": pa.array(["AIR", "SURFACE", "SEA", "LIBRARY"] * 5),
    })

    call_center = pa.table({
        "cc_call_center_sk": pa.array(np.arange(1, 5), pa.int64()),
        "cc_call_center_id": pa.array([f"CC{i:04d}" for i in range(1, 5)]),
        "cc_name": pa.array([f"call center {i}" for i in range(1, 5)]),
        "cc_county": pa.array([COUNTIES[i % 3] for i in range(4)]),
        "cc_manager": pa.array([f"Manager{i}" for i in range(1, 5)]),
    })

    web_site = pa.table({
        "web_site_sk": pa.array(np.arange(1, 5), pa.int64()),
        "web_site_id": pa.array([f"WEB{i:04d}" for i in range(1, 5)]),
        "web_name": pa.array([f"site_{i}" for i in range(4)]),
        "web_company_name": pa.array(["pri", "unto", "ese", "anti"]),
    })

    web_page = pa.table({
        "wp_web_page_sk": pa.array(np.arange(1, 61), pa.int64()),
        "wp_web_page_id": pa.array([f"WP{i:05d}" for i in range(1, 61)]),
        "wp_char_count": pa.array(
            rng.integers(100, 8000, 60), pa.int64()),
    })

    income_band = pa.table({
        "ib_income_band_sk": pa.array(np.arange(1, 21), pa.int64()),
        "ib_lower_bound": pa.array(
            (np.arange(20) * 10_000).astype(np.int64)),
        "ib_upper_bound": pa.array(
            ((np.arange(20) + 1) * 10_000).astype(np.int64)),
    })

    reason = pa.table({
        "r_reason_sk": pa.array(np.arange(1, 36), pa.int64()),
        "r_reason_id": pa.array([f"RSN{i:05d}" for i in range(1, 36)]),
        "r_reason_desc": pa.array([f"reason {i}" for i in range(1, 36)]),
    })

    # catalog_returns / web_returns: ~8%% / ~6%% of orders
    rcr = np.random.default_rng(seed + 200)
    n_cr = n_cs // 12
    cr_idx = rcr.choice(n_cs, n_cr, replace=False)
    cs_item = np.asarray(catalog_sales.column("cs_item_sk"))
    cs_cust = np.asarray(catalog_sales.column("cs_customer_sk"))
    cs_ord = np.asarray(catalog_sales.column("cs_order_number"))
    catalog_returns = pa.table({
        "cr_returned_date_sk": pa.array(
            rcr.integers(1, nd + 1, n_cr), pa.int64()),
        "cr_item_sk": pa.array(cs_item[cr_idx], pa.int64()),
        "cr_order_number": pa.array(cs_ord[cr_idx], pa.int64()),
        "cr_returning_customer_sk": pa.array(cs_cust[cr_idx], pa.int64()),
        "cr_return_quantity": pa.array(
            rcr.integers(1, 40, n_cr), pa.int64()),
        "cr_return_amount": pa.array(_money(rcr, n_cr, 1.0, 1500.0)),
        "cr_net_loss": pa.array(_money(rcr, n_cr, 0.5, 800.0)),
        "cr_call_center_sk": pa.array(
            rcr.integers(1, 5, n_cr), pa.int64()),
        "cr_returning_addr_sk": pa.array(
            rcr.integers(1, n_ca + 1, n_cr), pa.int64()),
        "cr_catalog_page_sk": pa.array(
            np.asarray(catalog_sales.column("cs_catalog_page_sk"))[cr_idx],
            pa.int64()),
    })
    rwr = np.random.default_rng(seed + 201)
    n_wr = n_ws // 16
    wr_idx = rwr.choice(n_ws, n_wr, replace=False)
    ws_item = np.asarray(web_sales.column("ws_item_sk"))
    ws_cust = np.asarray(web_sales.column("ws_customer_sk"))
    ws_ord = np.asarray(web_sales.column("ws_order_number"))
    web_returns = pa.table({
        "wr_returned_date_sk": pa.array(
            rwr.integers(1, nd + 1, n_wr), pa.int64()),
        "wr_item_sk": pa.array(ws_item[wr_idx], pa.int64()),
        "wr_order_number": pa.array(ws_ord[wr_idx], pa.int64()),
        "wr_returning_customer_sk": pa.array(ws_cust[wr_idx], pa.int64()),
        "wr_refunded_cdemo_sk": pa.array(
            rwr.integers(1, n_cd + 1, n_wr), pa.int64()),
        "wr_returning_addr_sk": pa.array(
            rwr.integers(1, n_ca + 1, n_wr), pa.int64()),
        "wr_refunded_addr_sk": pa.array(
            rwr.integers(1, n_ca + 1, n_wr), pa.int64()),
        "wr_return_quantity": pa.array(
            rwr.integers(1, 40, n_wr), pa.int64()),
        "wr_return_amt": pa.array(_money(rwr, n_wr, 1.0, 1500.0)),
        "wr_refunded_cash": pa.array(_money(rwr, n_wr, 0.5, 1200.0)),
        "wr_fee": pa.array(_money(rwr, n_wr, 0.5, 100.0)),
        "wr_net_loss": pa.array(_money(rwr, n_wr, 0.5, 800.0)),
        "wr_reason_sk": pa.array(rwr.integers(1, 36, n_wr), pa.int64()),
        "wr_web_page_sk": pa.array(rwr.integers(1, 61, n_wr), pa.int64()),
    })

    # inventory: weekly snapshots of a random item subset (q22)
    r = np.random.default_rng(seed + 123)
    week_sks = d_sk[::7]
    n_inv_per_week = max(200, n_item // 2)
    inv_date = np.repeat(week_sks, n_inv_per_week)
    n_inv = len(inv_date)
    inventory = pa.table({
        "inv_date_sk": pa.array(inv_date, pa.int64()),
        "inv_item_sk": pa.array(r.integers(1, n_item + 1, n_inv), pa.int64()),
        "inv_warehouse_sk": pa.array(r.integers(1, 6, n_inv), pa.int64()),
        "inv_quantity_on_hand": pa.array(
            r.integers(0, 1000, n_inv), pa.int64()),
    })

    return {
        "date_dim": date_dim, "time_dim": time_dim, "item": item,
        "inventory": inventory,
        "customer": customer, "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "household_demographics": household_demographics, "store": store,
        "promotion": promotion, "reason": reason,
        "warehouse": warehouse, "ship_mode": ship_mode,
        "call_center": call_center, "web_site": web_site,
        "catalog_page": catalog_page,
        "web_page": web_page, "income_band": income_band,
        "store_sales": store_sales, "catalog_sales": catalog_sales,
        "web_sales": web_sales, "store_returns": store_returns,
        "catalog_returns": catalog_returns, "web_returns": web_returns,
    }


def write_parquet(tables: Dict[str, pa.Table], out_dir: str) -> Dict[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, t in tables.items():
        p = os.path.join(out_dir, f"{name}.parquet")
        pq.write_table(t, p, row_group_size=1 << 16)
        paths[name] = p
    return paths
