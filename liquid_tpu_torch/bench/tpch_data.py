"""Deterministic TPC-H data generator (parquet output).

Equivalent role to the reference's pre-generated TPC-H data
(liquid-cache `benchmark/tpch/manifest.json` + `dev/test_parquet`):
eight tables with spec-shaped schemas, row counts scaled by `sf`, and
the value distributions the 22 queries depend on (brands, containers,
ship modes, order priorities, nation/region names, comment tokens...).

Correctness of query answers is verified DIFFERENTIALLY (engine vs an
independent pandas implementation on the same generated data), so this
generator does not need to reproduce official dbgen bytes -- it needs
deterministic, realistically-distributed data.  All randomness comes
from a fixed-seed numpy Generator.

Host copy of `liquid_tpu/bench/tpch_data.py`: the port imports nothing of
the reference package.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

EPOCH_1992 = np.datetime64("1992-01-01")
DATE_LO = np.datetime64("1992-01-01")
DATE_HI = np.datetime64("1998-08-02")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAME_WORDS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
                "black", "blanched", "blue", "blush", "brown", "burlywood",
                "burnished", "chartreuse", "chiffon", "chocolate", "coral",
                "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
                "dim", "dodger", "drab", "firebrick", "floral", "forest",
                "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
                "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
                "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
                "magenta", "maroon", "medium", "metallic", "midnight", "mint",
                "misty", "moccasin", "navajo", "navy", "olive", "orange",
                "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
                "powder", "puff", "purple", "red", "rose", "rosy", "royal",
                "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
                "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
                "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
COMMENT_WORDS = ["carefully", "quickly", "furiously", "slyly", "blithely",
                 "regular", "express", "special", "pending", "final", "bold",
                 "ironic", "even", "silent", "unusual", "requests", "deposits",
                 "packages", "foxes", "accounts", "theodolites", "pinto",
                 "beans", "instructions", "dependencies", "excuses", "ideas",
                 "platelets", "sleep", "wake", "nag", "haggle", "detect",
                 "complaints", "customer"]


def _money(rng, n, lo, hi):
    return np.round(rng.uniform(lo, hi, n), 2)


def _dates(rng, n, lo=DATE_LO, hi=DATE_HI):
    span = (hi - lo).astype("timedelta64[D]").astype(int)
    return lo + rng.integers(0, span + 1, n).astype("timedelta64[D]")


def _comments(rng, n, maxw=6):
    words = rng.choice(COMMENT_WORDS, size=(n, maxw))
    lens = rng.integers(2, maxw + 1, n)
    return np.array([" ".join(words[i, :lens[i]]) for i in range(n)])


def generate(sf: float = 0.01, seed: int = 19920101) -> Dict[str, pa.Table]:
    """-> {table_name: pa.Table} at scale factor `sf`."""
    rng = np.random.default_rng(seed)
    n_supp = max(10, int(10_000 * sf))
    n_part = max(200, int(200_000 * sf))
    n_cust = max(150, int(150_000 * sf))
    n_ord = max(1500, int(1_500_000 * sf))

    region = pa.table({
        "r_regionkey": pa.array(range(5), pa.int64()),
        "r_name": pa.array(REGIONS),
        "r_comment": pa.array(_comments(rng, 5)),
    })

    n_names = [n for n, _ in NATIONS]
    nation = pa.table({
        "n_nationkey": pa.array(range(25), pa.int64()),
        "n_name": pa.array(n_names),
        "n_regionkey": pa.array([r for _, r in NATIONS], pa.int64()),
        "n_comment": pa.array(_comments(rng, 25)),
    })

    s_nat = rng.integers(0, 25, n_supp)
    # Q20/Q21 filter comments LIKE '%Customer%Complaints%' / by nation
    s_comment = _comments(rng, n_supp)
    waiting = rng.random(n_supp) < 0.02
    s_comment = np.where(
        waiting, "wait Customer slow Complaints pending", s_comment)
    supplier = pa.table({
        "s_suppkey": pa.array(np.arange(1, n_supp + 1), pa.int64()),
        "s_name": pa.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)]),
        "s_address": pa.array([f"addr s{i}" for i in range(1, n_supp + 1)]),
        "s_nationkey": pa.array(s_nat, pa.int64()),
        "s_phone": pa.array([f"{nk + 10}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for nk in s_nat]),
        "s_acctbal": pa.array(_money(rng, n_supp, -999.99, 9999.99)),
        "s_comment": pa.array(s_comment),
    })

    c_nat = rng.integers(0, 25, n_cust)
    customer = pa.table({
        "c_custkey": pa.array(np.arange(1, n_cust + 1), pa.int64()),
        "c_name": pa.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)]),
        "c_address": pa.array([f"addr c{i}" for i in range(1, n_cust + 1)]),
        "c_nationkey": pa.array(c_nat, pa.int64()),
        "c_phone": pa.array([f"{nk + 10}-{rng.integers(100, 999)}-"
                             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
                             for nk in c_nat]),
        "c_acctbal": pa.array(_money(rng, n_cust, -999.99, 9999.99)),
        "c_mktsegment": pa.array(rng.choice(SEGMENTS, n_cust)),
        "c_comment": pa.array(_comments(rng, n_cust)),
    })

    w1 = rng.choice(P_NAME_WORDS, (n_part, 5))
    p_name = np.array([" ".join(w1[i]) for i in range(n_part)])
    p_mfgr_n = rng.integers(1, 6, n_part)
    p_brand_n = p_mfgr_n * 10 + rng.integers(1, 6, n_part)
    p_type = np.array([f"{rng.choice(TYPE_1)} {rng.choice(TYPE_2)} "
                       f"{rng.choice(TYPE_3)}" for _ in range(n_part)])
    part = pa.table({
        "p_partkey": pa.array(np.arange(1, n_part + 1), pa.int64()),
        "p_name": pa.array(p_name),
        "p_mfgr": pa.array([f"Manufacturer#{m}" for m in p_mfgr_n]),
        "p_brand": pa.array([f"Brand#{b}" for b in p_brand_n]),
        "p_type": pa.array(p_type),
        "p_size": pa.array(rng.integers(1, 51, n_part), pa.int64()),
        "p_container": pa.array(rng.choice(CONTAINERS, n_part)),
        "p_retailprice": pa.array(_money(rng, n_part, 900.0, 2000.0)),
        "p_comment": pa.array(_comments(rng, n_part, 3)),
    })

    # partsupp: 4 suppliers per part (spec layout)
    ps_part = np.repeat(np.arange(1, n_part + 1), 4)
    ps_supp = np.concatenate([
        1 + (np.arange(1, n_part + 1) - 1 + i * (n_supp // 4 + 1)) % n_supp
        for i in range(4)]).reshape(4, n_part).T.reshape(-1)
    n_ps = len(ps_part)
    partsupp = pa.table({
        "ps_partkey": pa.array(ps_part, pa.int64()),
        "ps_suppkey": pa.array(ps_supp, pa.int64()),
        "ps_availqty": pa.array(rng.integers(1, 10_000, n_ps), pa.int64()),
        "ps_supplycost": pa.array(_money(rng, n_ps, 1.0, 1000.0)),
        "ps_comment": pa.array(_comments(rng, n_ps, 3)),
    })

    o_key = np.arange(1, n_ord + 1) * 4 - 3  # sparse keys like dbgen
    # a third of customers never order (dbgen skips custkey % 3 == 0;
    # Q13/Q22 depend on order-less customers existing)
    cust_pool = np.arange(1, n_cust + 1)
    cust_pool = cust_pool[cust_pool % 3 != 0]
    o_cust = rng.choice(cust_pool, n_ord)
    o_date = _dates(rng, n_ord, DATE_LO, DATE_HI - np.timedelta64(151, "D"))
    o_comment = _comments(rng, n_ord)
    special = rng.random(n_ord) < 0.05
    o_comment = np.where(special, "slyly special packages requests haggle",
                         o_comment)
    orders_cols = {
        "o_orderkey": pa.array(o_key, pa.int64()),
        "o_custkey": pa.array(o_cust, pa.int64()),
        "o_totalprice": None,     # filled after lineitem
        "o_orderdate": pa.array(o_date.astype("datetime64[D]").astype(object)),
        "o_orderpriority": pa.array(rng.choice(PRIORITIES, n_ord)),
        "o_clerk": pa.array([f"Clerk#{rng.integers(1, 1001):09d}"
                             for _ in range(n_ord)]),
        "o_shippriority": pa.array(np.zeros(n_ord, np.int64)),
        "o_comment": pa.array(o_comment),
    }

    # lineitem: 1..7 lines per order
    lines_per = rng.integers(1, 8, n_ord)
    n_li = int(lines_per.sum())
    l_order = np.repeat(o_key, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    l_lineno = np.concatenate([np.arange(1, k + 1) for k in lines_per])
    l_part = rng.integers(1, n_part + 1, n_li)
    # supplier of a lineitem is one of the part's 4 partsupp suppliers
    pick = rng.integers(0, 4, n_li)
    l_supp = ps_supp.reshape(n_part, 4)[l_part - 1, pick]
    l_qty = rng.integers(1, 51, n_li).astype(np.float64)
    p_retail = np.asarray(part.column("p_retailprice"))
    l_extprice = np.round(l_qty * p_retail[l_part - 1], 2)
    l_disc = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    l_ship = l_odate + rng.integers(1, 122, n_li).astype("timedelta64[D]")
    l_commit = l_odate + rng.integers(30, 91, n_li).astype("timedelta64[D]")
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype("timedelta64[D]")
    l_rflag = np.where(l_receipt <= np.datetime64("1995-06-17"),
                       rng.choice(["R", "A"], n_li), "N")
    l_status = np.where(l_ship > np.datetime64("1995-06-17"), "O", "F")
    lineitem = pa.table({
        "l_orderkey": pa.array(l_order, pa.int64()),
        "l_partkey": pa.array(l_part, pa.int64()),
        "l_suppkey": pa.array(l_supp, pa.int64()),
        "l_linenumber": pa.array(l_lineno, pa.int64()),
        "l_quantity": pa.array(l_qty),
        "l_extendedprice": pa.array(l_extprice),
        "l_discount": pa.array(l_disc),
        "l_tax": pa.array(l_tax),
        "l_returnflag": pa.array(l_rflag),
        "l_linestatus": pa.array(l_status),
        "l_shipdate": pa.array(l_ship.astype("datetime64[D]").astype(object)),
        "l_commitdate": pa.array(l_commit.astype("datetime64[D]").astype(object)),
        "l_receiptdate": pa.array(l_receipt.astype("datetime64[D]").astype(object)),
        "l_shipinstruct": pa.array(rng.choice(INSTRUCTS, n_li)),
        "l_shipmode": pa.array(rng.choice(SHIPMODES, n_li)),
        "l_comment": pa.array(_comments(rng, n_li, 3)),
    })

    # o_totalprice = sum(extprice * (1+tax) * (1-disc)) per order
    per_line = l_extprice * (1 + l_tax) * (1 - l_disc)
    totals = np.zeros(n_ord)
    np.add.at(totals, np.repeat(np.arange(n_ord), lines_per), per_line)
    orders_cols["o_totalprice"] = pa.array(np.round(totals, 2))
    o_status = np.full(n_ord, "P")
    all_f = np.ones(n_ord, bool)
    any_f = np.zeros(n_ord, bool)
    idx = np.repeat(np.arange(n_ord), lines_per)
    f_mask = (l_status == "F")
    np.logical_and.at(all_f, idx, f_mask)
    np.logical_or.at(any_f, idx, f_mask)
    o_status = np.where(all_f, "F", np.where(~any_f, "O", "P"))
    orders_cols["o_orderstatus"] = pa.array(o_status)
    orders = pa.table(orders_cols)
    orders = orders.select([
        "o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
        "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
        "o_comment"])

    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


#: the money and quantity columns the TPC-H specification types
#: DECIMAL(15,2)
SPEC_DECIMALS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "p_retailprice", "ps_supplycost", "o_totalprice",
                 "s_acctbal", "c_acctbal")


def write_parquet(tables: Dict[str, pa.Table], out_dir: str
                  ) -> Dict[str, str]:
    """Each table to `out_dir/<name>.parquet` in row groups of 65,536
    rows -> {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, t in tables.items():
        p = os.path.join(out_dir, f"{name}.parquet")
        pq.write_table(t, p, row_group_size=1 << 16)
        paths[name] = p
    return paths


def with_spec_decimals(t: pa.Table, columns=SPEC_DECIMALS) -> pa.Table:
    """`t` with those of `columns` it holds cast to DECIMAL(15,2) (the
    generator's values have two decimals, so the cast is exact)."""
    return pa.table([t[c].cast(pa.decimal128(15, 2)) if c in columns
                     else t[c] for c in t.column_names],
                    names=t.column_names)
