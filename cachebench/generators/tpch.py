"""Seeded TPC-H tables, vectorised (a copy of
`liquid_tpu_torch/bench/tpch_data.py::generate` that takes the seed and
builds its strings and dates with numpy and pyarrow, not row by row).

The eight tables keep the specification's schemas, key layout (four
suppliers per part, sparse order keys, a third of the customers without
orders) and the value distributions the 22 queries depend on.  The data
follows those distributions; it is not dbgen's bytes.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

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
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hotpink", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "regular",
    "express", "special", "pending", "final", "bold", "ironic", "even",
    "silent", "unusual", "requests", "deposits", "packages", "foxes",
    "accounts", "theodolites", "pinto", "beans", "instructions",
    "dependencies", "excuses", "ideas", "platelets", "sleep", "wake", "nag",
    "haggle", "detect", "complaints", "customer"]


def _money(rng, n, lo, hi):
    return np.round(rng.uniform(lo, hi, n), 2)


def _dates(rng, n, lo=DATE_LO, hi=DATE_HI):
    span = (hi - lo).astype("timedelta64[D]").astype(int)
    return lo + rng.integers(0, span + 1, n).astype("timedelta64[D]")


def _pick(rng, vocab, n) -> pa.Array:
    return pa.array(vocab).take(pa.array(rng.integers(0, len(vocab), n)))


def _words(rng, vocab, lens: np.ndarray, sep=" ") -> pa.Array:
    """Row i: `lens[i]` words drawn from `vocab`, joined by `sep`."""
    offsets = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    words = _pick(rng, vocab, int(offsets[-1]))
    return pc.binary_join(pa.ListArray.from_arrays(pa.array(offsets), words),
                          sep)


def _comments(rng, n, maxw=6) -> pa.Array:
    return _words(rng, COMMENT_WORDS, rng.integers(2, maxw + 1, n))


def _text(*parts) -> pa.Array:
    """Element-wise concatenation of strings, string arrays and integer
    arrays (printed in decimal)."""
    cols = [p if isinstance(p, str) else pa.array(p).cast(pa.string())
            for p in parts]
    return pc.binary_join_element_wise(*cols, "")


def _padded(prefix: str, ids: np.ndarray, width: int = 9) -> pa.Array:
    return pc.binary_join_element_wise(
        prefix, pc.utf8_lpad(pa.array(ids).cast(pa.string()), width, "0"),
        "")


def _phones(rng, nations: np.ndarray) -> pa.Array:
    n = len(nations)
    return _text(nations + 10, "-", rng.integers(100, 999, n), "-",
                 rng.integers(100, 999, n), "-", rng.integers(1000, 9999, n))


def _date32(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype("datetime64[D]"))


def generate(sf: float, seed: int) -> Dict[str, pa.Table]:
    """-> {table name: pa.Table} at scale factor `sf`, drawn from `seed`."""
    rng = np.random.default_rng(seed % (1 << 64))
    n_supp = max(10, int(10_000 * sf))
    n_part = max(200, int(200_000 * sf))
    n_cust = max(150, int(150_000 * sf))
    n_ord = max(1500, int(1_500_000 * sf))

    region = pa.table({
        "r_regionkey": pa.array(range(5), pa.int64()),
        "r_name": pa.array(REGIONS),
        "r_comment": _comments(rng, 5),
    })
    nation = pa.table({
        "n_nationkey": pa.array(range(25), pa.int64()),
        "n_name": pa.array([n for n, _ in NATIONS]),
        "n_regionkey": pa.array([r for _, r in NATIONS], pa.int64()),
        "n_comment": _comments(rng, 25),
    })

    supp_keys = np.arange(1, n_supp + 1)
    s_nat = rng.integers(0, 25, n_supp)
    # q16 and q21 read suppliers whose comment holds Customer...Complaints
    waiting = rng.random(n_supp) < 0.02
    s_comment = pc.if_else(pa.array(waiting),
                           "wait Customer slow Complaints pending",
                           _comments(rng, n_supp))
    supplier = pa.table({
        "s_suppkey": pa.array(supp_keys, pa.int64()),
        "s_name": _padded("Supplier#", supp_keys),
        "s_address": _text("addr s", supp_keys),
        "s_nationkey": pa.array(s_nat, pa.int64()),
        "s_phone": _phones(rng, s_nat),
        "s_acctbal": pa.array(_money(rng, n_supp, -999.99, 9999.99)),
        "s_comment": s_comment,
    })

    cust_keys = np.arange(1, n_cust + 1)
    c_nat = rng.integers(0, 25, n_cust)
    customer = pa.table({
        "c_custkey": pa.array(cust_keys, pa.int64()),
        "c_name": _padded("Customer#", cust_keys),
        "c_address": _text("addr c", cust_keys),
        "c_nationkey": pa.array(c_nat, pa.int64()),
        "c_phone": _phones(rng, c_nat),
        "c_acctbal": pa.array(_money(rng, n_cust, -999.99, 9999.99)),
        "c_mktsegment": _pick(rng, SEGMENTS, n_cust),
        "c_comment": _comments(rng, n_cust),
    })

    p_mfgr_n = rng.integers(1, 6, n_part)
    p_brand_n = p_mfgr_n * 10 + rng.integers(1, 6, n_part)
    p_retail = _money(rng, n_part, 900.0, 2000.0)
    part = pa.table({
        "p_partkey": pa.array(np.arange(1, n_part + 1), pa.int64()),
        "p_name": _words(rng, P_NAME_WORDS, np.full(n_part, 5)),
        "p_mfgr": _text("Manufacturer#", p_mfgr_n),
        "p_brand": _text("Brand#", p_brand_n),
        "p_type": pc.binary_join_element_wise(
            _pick(rng, TYPE_1, n_part), _pick(rng, TYPE_2, n_part),
            _pick(rng, TYPE_3, n_part), " "),
        "p_size": pa.array(rng.integers(1, 51, n_part), pa.int64()),
        "p_container": _pick(rng, CONTAINERS, n_part),
        "p_retailprice": pa.array(p_retail),
        "p_comment": _comments(rng, n_part, 3),
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
        "ps_comment": _comments(rng, n_ps, 3),
    })

    o_key = np.arange(1, n_ord + 1) * 4 - 3  # sparse keys like dbgen
    # a third of customers never order (dbgen skips custkey % 3 == 0;
    # q13 and q22 depend on order-less customers existing)
    cust_pool = cust_keys[cust_keys % 3 != 0]
    o_cust = rng.choice(cust_pool, n_ord)
    o_date = _dates(rng, n_ord, DATE_LO, DATE_HI - np.timedelta64(151, "D"))
    special = rng.random(n_ord) < 0.05
    o_comment = pc.if_else(pa.array(special),
                           "slyly special packages requests haggle",
                           _comments(rng, n_ord))
    o_priority = _pick(rng, PRIORITIES, n_ord)
    o_clerk = _padded("Clerk#", rng.integers(1, 1001, n_ord))

    # lineitem: 1..7 lines per order, each count equally often, so that
    # every seed gives the same number of lines (5,999,995 at SF 1)
    lines_per = rng.permutation(np.resize(np.arange(1, 8), n_ord))
    n_li = int(lines_per.sum())
    order_of = np.repeat(np.arange(n_ord), lines_per)
    starts = np.concatenate([[0], np.cumsum(lines_per)[:-1]])
    l_lineno = np.arange(n_li) - starts[order_of] + 1
    l_odate = o_date[order_of]
    l_part = rng.integers(1, n_part + 1, n_li)
    # the supplier of a line is one of its part's 4 partsupp suppliers
    l_supp = ps_supp.reshape(n_part, 4)[l_part - 1, rng.integers(0, 4, n_li)]
    l_qty = rng.integers(1, 51, n_li).astype(np.float64)
    l_extprice = np.round(l_qty * p_retail[l_part - 1], 2)
    l_disc = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    l_tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    l_ship = l_odate + rng.integers(1, 122, n_li).astype("timedelta64[D]")
    l_commit = l_odate + rng.integers(30, 91, n_li).astype("timedelta64[D]")
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype("timedelta64[D]")
    returned = np.array(["R", "A"])[rng.integers(0, 2, n_li)]
    l_rflag = np.where(l_receipt <= np.datetime64("1995-06-17"), returned,
                       "N")
    l_status = np.where(l_ship > np.datetime64("1995-06-17"), "O", "F")
    lineitem = pa.table({
        "l_orderkey": pa.array(o_key[order_of], pa.int64()),
        "l_partkey": pa.array(l_part, pa.int64()),
        "l_suppkey": pa.array(l_supp, pa.int64()),
        "l_linenumber": pa.array(l_lineno, pa.int64()),
        "l_quantity": pa.array(l_qty),
        "l_extendedprice": pa.array(l_extprice),
        "l_discount": pa.array(l_disc),
        "l_tax": pa.array(l_tax),
        "l_returnflag": pa.array(l_rflag),
        "l_linestatus": pa.array(l_status),
        "l_shipdate": _date32(l_ship),
        "l_commitdate": _date32(l_commit),
        "l_receiptdate": _date32(l_receipt),
        "l_shipinstruct": _pick(rng, INSTRUCTS, n_li),
        "l_shipmode": _pick(rng, SHIPMODES, n_li),
        "l_comment": _comments(rng, n_li, 3),
    })

    # o_totalprice = sum(extprice * (1 + tax) * (1 - disc)) per order;
    # the status is F when every line is F, O when none is, else P
    totals = np.bincount(order_of, l_extprice * (1 + l_tax) * (1 - l_disc),
                         n_ord)
    f_lines = np.bincount(order_of, l_status == "F", n_ord)
    o_status = np.where(f_lines == lines_per, "F",
                        np.where(f_lines == 0, "O", "P"))
    orders = pa.table({
        "o_orderkey": pa.array(o_key, pa.int64()),
        "o_custkey": pa.array(o_cust, pa.int64()),
        "o_orderstatus": pa.array(o_status),
        "o_totalprice": pa.array(np.round(totals, 2)),
        "o_orderdate": _date32(o_date),
        "o_orderpriority": o_priority,
        "o_clerk": o_clerk,
        "o_shippriority": pa.array(np.zeros(n_ord, np.int64)),
        "o_comment": o_comment,
    })

    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


def write(config: dict, seed: int, out_dir: str) -> Dict[str, str]:
    """Every table of `config` as `out_dir/<table>.parquet` -> {table:
    path}."""
    tables = generate(config["scale_factor"], seed)
    paths = {}
    for name in config["tables"]:
        paths[name] = os.path.join(out_dir, f"{name}.parquet")
        pq.write_table(tables[name], paths[name],
                       row_group_size=config["row_group_rows"])
    return paths
