"""Seeded TPC-DS tables, vectorised (a copy of
`liquid_tpu_torch/bench/tpcds_data.py::generate` that takes the seed,
builds its strings with pyarrow, not row by row, and sizes its tables by
the specification's SF 1 row counts).

The tables keep the schemas and column names the port's 95 TPC-DS queries
read, and the value distributions their fixed parameters depend on.  The
data follows those distributions; it is not dsdgen's bytes.

Sizes at `scale_factor` 1 are the specification's: the sales, returns,
item, customer and address tables scale with it (floors keep a CPU test's
tiny tables non-empty); `customer_demographics` is the specification's
cross product of its eight domains (1,920,800 rows), a prefix of it below
SF 1; `date_dim` (1900-01-02 to 2100-01-01), `time_dim` and the small
dimensions are fixed.  Dates of sales and returns fall in 1998-2003, the
years the queries' parameters name; `d_month_seq` and `d_week_seq` count
from 1998-01 (the queries' `d_month_seq between 24 and 35` is 2000), so
they are negative before 1998.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

#: the specification's row counts at SF 1
SF1_ROWS = {
    "store_sales": 2_880_404, "catalog_sales": 1_441_548,
    "web_sales": 719_384, "store_returns": 287_514,
    "catalog_returns": 144_067, "web_returns": 71_763,
    "customer_demographics": 1_920_800, "date_dim": 73_049,
    "time_dim": 86_400, "item": 18_000, "customer": 100_000,
    "customer_address": 50_000, "store": 12, "catalog_page": 11_718,
    "web_site": 30, "web_page": 60,
}
#: the tables whose rows scale with the scale factor, and their floors
SCALED = {"store_sales": 60_000, "catalog_sales": 30_000,
          "web_sales": 15_000, "store_returns": 6_000,
          "catalog_returns": 3_000, "web_returns": 1_500,
          "customer_demographics": 39_200, "item": 2_000,
          "customer": 1_000, "customer_address": 500}
#: the dimensions of the channels that the sales tables' keys range over
#: (at SF 1; the specification's household_demographics and promotion)
N_HDEMO, N_PROMO, N_CALL_CENTER, N_WAREHOUSE = 7_200, 300, 6, 5

DATE0 = np.datetime64("1900-01-02")
DATE_SK0 = 2_415_022          # d_date_sk of 1900-01-02, as dsdgen numbers
SALES_LO = np.datetime64("1998-01-01")
SALES_HI = np.datetime64("2004-01-01")  # exclusive

CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Men", "Music",
              "Shoes", "Sports", "Children", "Women"]
STATES = ["AL", "CA", "GA", "IL", "IN", "KS", "KY", "MI", "MN", "MO",
          "NC", "NY", "OH", "TN", "TX", "VA", "WA", "WI"]
COUNTIES = [f"{w} County" for w in
            ["Ziebach", "Walker", "Williamson", "Franklin", "Fairfield",
             "Bronx", "Orange", "Daviess", "Barrow", "Luce"]]
# customer_demographics' domains, in the specification's order (the first
# varies fastest along cd_demo_sk)
GENDER = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
PURCHASE = list(range(500, 10_001, 500))
CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
DEPS = list(range(7))
COLORS = ["red", "blue", "green", "yellow", "purple", "orange", "white",
          "black", "pink", "brown", "cyan", "magenta"]
SIZES = ["small", "medium", "large", "extra large", "petite", "N/A"]
UNITS = ["Each", "Dozen", "Case", "Pallet", "Box", "Unknown"]
DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday"]


def rows(table: str, sf: float) -> int:
    """The table's row count at scale factor `sf`."""
    n = SF1_ROWS[table]
    if table not in SCALED:
        return n
    return min(n, max(SCALED[table], int(round(n * sf)))) if sf < 1 \
        else int(round(n * sf))


def _money(rng, n, lo, hi) -> np.ndarray:
    return np.round(rng.uniform(lo, hi, n), 2)


def _pick(rng, vocab, n) -> pa.Array:
    return pa.array(vocab).take(pa.array(rng.integers(0, len(vocab), n)))


def _text(*parts) -> pa.Array:
    """Element-wise concatenation of strings, string arrays and integer
    arrays (printed in decimal)."""
    cols = [p if isinstance(p, str) else pa.array(p).cast(pa.string())
            for p in parts]
    return pc.binary_join_element_wise(*cols, "")


def _padded(prefix: str, ids: np.ndarray, width: int) -> pa.Array:
    return pc.binary_join_element_wise(
        prefix, pc.utf8_lpad(pa.array(ids).cast(pa.string()), width, "0"),
        "")


def _keys(n: int) -> pa.Array:
    return pa.array(np.arange(1, n + 1), pa.int64())


def _i64(a) -> pa.Array:
    return pa.array(np.asarray(a, np.int64))


def _date32(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype("datetime64[D]"))


class _Gen:
    """The tables of one draw, each built on first use from a random
    stream of its own (the seed and the table's name), so that a table is
    the same whichever others are asked for."""

    def __init__(self, sf: float, seed: int):
        self.seed = seed % (1 << 63)
        self.tables: Dict[str, pa.Table] = {}
        self.n = {t: rows(t, sf) for t in SF1_ROWS}

    def rng(self, table: str) -> np.random.Generator:
        return np.random.default_rng([self.seed, *table.encode()])

    def get(self, name: str) -> pa.Table:
        if name not in self.tables:
            self.tables[name] = getattr(self, name)()
        return self.tables[name]

    # -- dimensions ----------------------------------------------------------

    def date_dim(self) -> pa.Table:
        n = self.n["date_dim"]
        d = DATE0 + np.arange(n).astype("timedelta64[D]")
        yy = d.astype("datetime64[Y]").astype(np.int64) + 1970
        mm = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
        days = d.view(np.int64)
        dow = (days + 4) % 7
        dom = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
        day0 = SALES_LO.astype("datetime64[D]").view(np.int64)
        return pa.table({
            "d_date_sk": _i64(DATE_SK0 + np.arange(n)),
            "d_date": _date32(d),
            "d_year": _i64(yy),
            "d_moy": _i64(mm),
            "d_dom": _i64(dom),
            "d_dow": _i64(dow),
            "d_qoy": _i64((mm - 1) // 3 + 1),
            "d_month_seq": _i64((yy - 1998) * 12 + mm - 1),
            "d_week_seq": _i64((days - day0 + 4) // 7),
            "d_day_name": pa.array(DAY_NAMES).take(pa.array(dow)),
        })

    def time_dim(self) -> pa.Table:
        t = np.arange(86_400, dtype=np.int64)
        hour = t // 3600
        meal = np.where((hour >= 6) & (hour <= 8), 0,
                        np.where((hour >= 17) & (hour <= 19), 1, -1))
        return pa.table({
            "t_time_sk": pa.array(t), "t_time": pa.array(t),
            "t_hour": pa.array(hour), "t_minute": pa.array(t % 3600 // 60),
            "t_meal_time": pa.array(["breakfast", "dinner"]).take(
                pa.array(meal, mask=meal < 0)),
        })

    def item(self) -> pa.Table:
        n, r = self.n["item"], self.rng("item")
        ids = np.arange(1, n + 1)
        cat = r.integers(0, len(CATEGORIES), n)
        cls = r.integers(1, 8, n)
        cat_words = pc.utf8_lower(pc.utf8_slice_codeunits(
            pa.array(CATEGORIES), 0, 4)).take(pa.array(cat))
        return pa.table({
            "i_item_sk": _keys(n),
            "i_item_id": _padded("AAAAAAAA", ids, 8),
            "i_item_desc": _text("item desc ", ids),
            "i_product_name": _padded("product", ids, 7),
            "i_category": pa.array(CATEGORIES).take(pa.array(cat)),
            "i_class": _text(cat_words, "class", cls),
            "i_brand": _text("brand#", r.integers(1, 100, n)),
            "i_brand_id": _i64(r.integers(1_000_001, 10_016_017, n)),
            "i_manufact_id": _i64(np.arange(n) % 1000 + 1),
            "i_manager_id": _i64(np.arange(n) % 100 + 1),
            "i_current_price": pa.array(_money(r, n, 0.5, 100.0)),
            "i_wholesale_cost": pa.array(_money(r, n, 0.3, 70.0)),
            "i_category_id": _i64(cat + 1),
            "i_class_id": _i64((cat + 1) * 10 + cls),
            "i_color": _pick(r, COLORS, n),
            "i_size": _pick(r, SIZES, n),
            "i_units": _pick(r, UNITS, n),
        })

    def customer_address(self) -> pa.Table:
        n, r = self.n["customer_address"], self.rng("customer_address")
        return pa.table({
            "ca_address_sk": _keys(n),
            "ca_state": _pick(r, STATES, n),
            "ca_county": _pick(r, COUNTIES, n),
            "ca_city": _text("city", r.integers(1, 200, n)),
            "ca_country": pa.array(["United States"] * n),
            "ca_zip": _text(r.integers(10_000, 99_999, n)),
            "ca_gmt_offset": pa.array(
                np.array([-5.0, -6.0, -7.0, -8.0])[r.integers(0, 4, n)]),
        })

    def customer_demographics(self) -> pa.Table:
        n = self.n["customer_demographics"]
        k = np.arange(n)
        out = {"cd_demo_sk": _keys(n)}
        step = 1
        for name, dom in (("cd_gender", GENDER),
                          ("cd_marital_status", MARITAL),
                          ("cd_education_status", EDUCATION),
                          ("cd_purchase_estimate", PURCHASE),
                          ("cd_credit_rating", CREDIT),
                          ("cd_dep_count", DEPS),
                          ("cd_dep_employed_count", DEPS),
                          ("cd_dep_college_count", DEPS)):
            idx = k // step % len(dom)
            out[name] = (pa.array(dom).take(pa.array(idx))
                         if isinstance(dom[0], str)
                         else _i64(np.asarray(dom)[idx]))
            step *= len(dom)
        return pa.table(out)

    def customer(self) -> pa.Table:
        n, r = self.n["customer"], self.rng("customer")
        i = np.arange(n)
        return pa.table({
            "c_customer_sk": _keys(n),
            "c_customer_id": _padded("CUST", i + 1, 12),
            "c_first_name": _text("First", i % 500),
            "c_last_name": _text("Last", i % 700),
            "c_salutation": _pick(
                r, ["Mr.", "Mrs.", "Ms.", "Dr.", "Sir", "Miss"], n),
            "c_preferred_cust_flag": _pick(r, ["Y", "N"], n),
            "c_current_addr_sk": _i64(
                r.integers(1, self.n["customer_address"] + 1, n)),
            "c_current_cdemo_sk": _i64(
                r.integers(1, self.n["customer_demographics"] + 1, n)),
            "c_current_hdemo_sk": _i64(r.integers(1, N_HDEMO + 1, n)),
            "c_birth_country": _pick(
                r, ["UNITED STATES", "CANADA", "MEXICO", "GERMANY",
                    "JAPAN"], n),
            "c_birth_year": _i64(r.integers(1924, 1993, n)),
            "c_birth_month": _i64(r.integers(1, 13, n)),
        })

    def store(self) -> pa.Table:
        n, r = self.n["store"], self.rng("store")
        ids = np.arange(1, n + 1)
        return pa.table({
            "s_store_sk": _keys(n),
            "s_store_id": _padded("ST", ids, 6),
            "s_store_name": pa.array([f"store {chr(96 + i)}" for i in ids]),
            "s_company_name": pa.array(["Unknown"] * n),
            "s_state": _pick(r, STATES[:6], n),
            "s_county": pa.array(COUNTIES).take(
                pa.array(np.arange(n) % len(COUNTIES))),
            "s_city": _text("city", ids),
            "s_number_employees": _i64(r.integers(200, 301, n)),
            "s_gmt_offset": pa.array(
                np.array([-5.0, -6.0])[r.integers(0, 2, n)]),
            "s_zip": _text(r.integers(10_000, 99_999, n)),
            "s_market_id": _i64(r.integers(1, 11, n)),
        })

    def catalog_page(self) -> pa.Table:
        n = self.n["catalog_page"]
        return pa.table({
            "cp_catalog_page_sk": _keys(n),
            "cp_catalog_page_id": _padded("CPAG", np.arange(1, n + 1), 8),
        })

    def web_site(self) -> pa.Table:
        n = self.n["web_site"]
        ids = np.arange(1, n + 1)
        return pa.table({
            "web_site_sk": _keys(n),
            "web_site_id": _padded("WEB", ids, 4),
            "web_name": _text("site_", ids - 1),
            "web_company_name": pa.array(["pri", "unto", "ese", "anti"]).take(
                pa.array((ids - 1) % 4)),
        })

    def web_page(self) -> pa.Table:
        n, r = self.n["web_page"], self.rng("web_page")
        return pa.table({
            "wp_web_page_sk": _keys(n),
            "wp_web_page_id": _padded("WP", np.arange(1, n + 1), 5),
            "wp_char_count": _i64(r.integers(100, 8000, n)),
        })

    # -- facts ---------------------------------------------------------------

    def _date_sks(self, r, n) -> np.ndarray:
        lo = int((SALES_LO - DATE0).astype(np.int64))
        hi = int((SALES_HI - DATE0).astype(np.int64))
        return DATE_SK0 + r.integers(lo, hi, n)

    def _sales(self, table: str, pfx: str) -> Dict[str, pa.Array]:
        """The columns the three channels share."""
        n, r = self.n[table], self.rng(table)
        qty = r.integers(1, 101, n).astype(np.float64)
        wholesale = _money(r, n, 1.0, 100.0)
        list_price = np.round(wholesale * r.uniform(1.0, 2.5, n), 2)
        sales_price = np.round(list_price * r.uniform(0.2, 1.0, n), 2)
        ext_sales = np.round(sales_price * qty, 2)
        ext_wholesale = np.round(wholesale * qty, 2)
        coupon = np.where(r.random(n) < 0.1, np.round(ext_sales * 0.1, 2),
                          0.0)
        net_paid = np.round(ext_sales - coupon, 2)
        number = "ticket_number" if pfx == "ss" else "order_number"
        return {
            f"{pfx}_sold_date_sk": _i64(self._date_sks(r, n)),
            f"{pfx}_sold_time_sk": _i64(r.integers(0, 86_400, n)),
            f"{pfx}_item_sk": _i64(r.integers(1, self.n["item"] + 1, n)),
            f"{pfx}_customer_sk": _i64(
                r.integers(1, self.n["customer"] + 1, n)),
            f"{pfx}_cdemo_sk": _i64(
                r.integers(1, self.n["customer_demographics"] + 1, n)),
            f"{pfx}_hdemo_sk": _i64(r.integers(1, N_HDEMO + 1, n)),
            f"{pfx}_addr_sk": _i64(
                r.integers(1, self.n["customer_address"] + 1, n)),
            f"{pfx}_{number}": _keys(n),
            f"{pfx}_quantity": pa.array(qty),
            f"{pfx}_wholesale_cost": pa.array(wholesale),
            f"{pfx}_list_price": pa.array(list_price),
            f"{pfx}_sales_price": pa.array(sales_price),
            f"{pfx}_ext_discount_amt": pa.array(
                np.round((list_price - sales_price) * qty, 2)),
            f"{pfx}_ext_sales_price": pa.array(ext_sales),
            f"{pfx}_ext_list_price": pa.array(np.round(list_price * qty, 2)),
            f"{pfx}_ext_wholesale_cost": pa.array(ext_wholesale),
            f"{pfx}_coupon_amt": pa.array(coupon),
            f"{pfx}_net_paid": pa.array(net_paid),
            f"{pfx}_net_profit": pa.array(
                np.round(net_paid - ext_wholesale, 2)),
            f"{pfx}_promo_sk": _i64(r.integers(1, N_PROMO + 1, n)),
        }

    def _ship(self, r, sold: pa.Array, n: int) -> pa.Array:
        """A ship date up to four months after the sale."""
        return _i64(np.asarray(sold) + r.integers(1, 121, n))

    def store_sales(self) -> pa.Table:
        cols = self._sales("store_sales", "ss")
        n, r = self.n["store_sales"], self.rng("store_sales.keys")
        # a few percent of the keys are NULL, as dsdgen leaves them
        cols["ss_sold_time_sk"] = pa.array(
            np.asarray(cols["ss_sold_time_sk"]), pa.int64(),
            mask=r.random(n) < 0.04)
        cols["ss_store_sk"] = _i64(r.integers(1, self.n["store"] + 1, n))
        return pa.table(cols)

    def catalog_sales(self) -> pa.Table:
        cols = self._sales("catalog_sales", "cs")
        n, r = self.n["catalog_sales"], self.rng("catalog_sales.keys")
        cols["cs_ship_addr_sk"] = pa.array(
            r.integers(1, self.n["customer_address"] + 1, n), pa.int64(),
            mask=r.random(n) < 0.04)
        cols["cs_ship_date_sk"] = self._ship(r, cols["cs_sold_date_sk"], n)
        cols["cs_ship_mode_sk"] = _i64(r.integers(1, 21, n))
        cols["cs_call_center_sk"] = _i64(r.integers(1, N_CALL_CENTER + 1, n))
        cols["cs_warehouse_sk"] = _i64(r.integers(1, N_WAREHOUSE + 1, n))
        cols["cs_catalog_page_sk"] = _i64(
            r.integers(1, self.n["catalog_page"] + 1, n))
        return pa.table(cols)

    def web_sales(self) -> pa.Table:
        cols = self._sales("web_sales", "ws")
        n, r = self.n["web_sales"], self.rng("web_sales.keys")
        # orders of two lines each (q95 wants orders over two warehouses)
        cols["ws_order_number"] = _i64(np.arange(n) // 2 + 1)
        cols["ws_ship_customer_sk"] = pa.array(
            r.integers(1, self.n["customer"] + 1, n), pa.int64(),
            mask=r.random(n) < 0.04)
        cols["ws_ship_date_sk"] = self._ship(r, cols["ws_sold_date_sk"], n)
        cols["ws_ship_mode_sk"] = _i64(r.integers(1, 21, n))
        cols["ws_web_site_sk"] = _i64(r.integers(1, self.n["web_site"] + 1,
                                                 n))
        cols["ws_warehouse_sk"] = _i64(r.integers(1, N_WAREHOUSE + 1, n))
        cols["ws_web_page_sk"] = _i64(r.integers(1, self.n["web_page"] + 1,
                                                 n))
        cols["ws_ship_addr_sk"] = _i64(
            r.integers(1, self.n["customer_address"] + 1, n))
        return pa.table(cols)

    def _returned(self, table: str, sales: str):
        """(rng, the sales rows returned, their count): distinct lines."""
        n, r = self.n[table], self.rng(table)
        m = self.get(sales).num_rows
        return r, np.sort(r.choice(m, min(n, m), replace=False)), min(n, m)

    def store_returns(self) -> pa.Table:
        r, idx, n = self._returned("store_returns", "store_sales")
        ss = self.get("store_sales")
        take = pa.array(idx)
        return pa.table({
            "sr_returned_date_sk": _i64(self._date_sks(r, n)),
            "sr_item_sk": ss["ss_item_sk"].take(take),
            "sr_customer_sk": ss["ss_customer_sk"].take(take),
            "sr_ticket_number": ss["ss_ticket_number"].take(take),
            "sr_return_quantity": _i64(r.integers(1, 50, n)),
            "sr_return_amt": pa.array(_money(r, n, 1.0, 2000.0)),
            "sr_net_loss": pa.array(_money(r, n, 0.5, 1000.0)),
            "sr_cdemo_sk": _i64(
                r.integers(1, self.n["customer_demographics"] + 1, n)),
            "sr_reason_sk": _i64(r.integers(1, 36, n)),
            "sr_store_sk": ss["ss_store_sk"].take(take),
        }).combine_chunks()

    def catalog_returns(self) -> pa.Table:
        r, idx, n = self._returned("catalog_returns", "catalog_sales")
        cs = self.get("catalog_sales")
        take = pa.array(idx)
        return pa.table({
            "cr_returned_date_sk": _i64(self._date_sks(r, n)),
            "cr_item_sk": cs["cs_item_sk"].take(take),
            "cr_order_number": cs["cs_order_number"].take(take),
            "cr_returning_customer_sk": cs["cs_customer_sk"].take(take),
            "cr_return_quantity": _i64(r.integers(1, 40, n)),
            "cr_return_amount": pa.array(_money(r, n, 1.0, 1500.0)),
            "cr_net_loss": pa.array(_money(r, n, 0.5, 800.0)),
            "cr_call_center_sk": _i64(r.integers(1, N_CALL_CENTER + 1, n)),
            "cr_returning_addr_sk": _i64(
                r.integers(1, self.n["customer_address"] + 1, n)),
            "cr_catalog_page_sk": cs["cs_catalog_page_sk"].take(take),
        }).combine_chunks()

    def web_returns(self) -> pa.Table:
        r, idx, n = self._returned("web_returns", "web_sales")
        ws = self.get("web_sales")
        take = pa.array(idx)
        n_ca = self.n["customer_address"]
        return pa.table({
            "wr_returned_date_sk": _i64(self._date_sks(r, n)),
            "wr_item_sk": ws["ws_item_sk"].take(take),
            "wr_order_number": ws["ws_order_number"].take(take),
            "wr_returning_customer_sk": ws["ws_customer_sk"].take(take),
            "wr_refunded_cdemo_sk": _i64(
                r.integers(1, self.n["customer_demographics"] + 1, n)),
            "wr_returning_addr_sk": _i64(r.integers(1, n_ca + 1, n)),
            "wr_refunded_addr_sk": _i64(r.integers(1, n_ca + 1, n)),
            "wr_return_quantity": _i64(r.integers(1, 40, n)),
            "wr_return_amt": pa.array(_money(r, n, 1.0, 1500.0)),
            "wr_refunded_cash": pa.array(_money(r, n, 0.5, 1200.0)),
            "wr_fee": pa.array(_money(r, n, 0.5, 100.0)),
            "wr_net_loss": pa.array(_money(r, n, 0.5, 800.0)),
            "wr_reason_sk": _i64(r.integers(1, 36, n)),
            "wr_web_page_sk": _i64(r.integers(1, self.n["web_page"] + 1, n)),
        }).combine_chunks()


#: every table the generator makes
TABLES: List[str] = list(SF1_ROWS)


def generate(sf: float, seed: int, tables=None) -> Dict[str, pa.Table]:
    """-> {table name: pa.Table} of `tables` (default all) at scale factor
    `sf`, drawn from `seed`."""
    g = _Gen(sf, seed)
    return {t: g.get(t) for t in (tables or TABLES)}


def write(config: dict, seed: int, out_dir: str) -> Dict[str, str]:
    """Every table of `config` as `out_dir/<table>.parquet` -> {table:
    path}."""
    g = _Gen(config["scale_factor"], seed)
    paths = {}
    for name in config["tables"]:
        paths[name] = os.path.join(out_dir, f"{name}.parquet")
        pq.write_table(g.get(name), paths[name],
                       row_group_size=config["row_group_rows"])
    return paths
