#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`liquid_tpu_torch`) on one GPU.

    python3 chip_smoke.py                  # full size, needs one CUDA card
    python3 chip_smoke.py --hits-rows 400000 --sf 0.2    # a quicker run
    python3 chip_smoke.py --trash-band NAME [--tree DIR]  # scatter times only

Phases (any failure raises and the script exits non-zero):
1. device: name, count, `nvidia-smi` name and power limit;
2. build the kernels from the checkout's sources, one nvcc per source,
   all started together with g++ for the native FSST library
   (`native/*.cpp` into `liquid_tpu_torch/_build/`), timed: K1
   (`ops/csrc/cmp_const_many.cu`), K2 (`ops/csrc/group_accumulate.cu`),
   K3 and K4 (`ops/csrc/cmp_planes.cu`); K2's shared-memory atomics read
   from its SASS (`cuobjdump -sass`), failing on a CAS loop;
3. K1 against its plain PyTorch version on the card, bit-exact, over
   every width bucket 1..64, B in {1, 3, 489, 4097} and constants 0, 1,
   random, with bits at or above the width, and 2^64-1: the single form,
   and the interval form (`in_interval_many`) with lo <= hi, lo > hi and
   bounds beyond the width;
4. K2 against its plain version on the card, bit-exact, over m in {1,
   63, 8889, 16385, 65535}, C in {1, 4, 7, 16}, n in {2048, 4097,
   4,005,888, 4,005,891}, uniform and zipf-skewed slots with negative and
   out-of-range slots mixed in, values over the full i32 range (m =
   65535 splits the slot range across CTAs; 4097 and 4,005,891 leave a
   ragged tail);
   4b. K3 (`count_gt`) and K4 (`cmp_const_planes`) against their plain
   versions, bit-exact, over every width 0..64, W in {256, 4096, 2^22}
   words, constants 0, 1, random, 2^w-1, with bits at or above w, and
   2^64-1, on flat and prepped planes;
5. the scalar main path: 4,000,000 synthesized ClickBench `hits` rows and
   TPC-H SF1 `lineitem` as parquet, a `LiquidCacheLocalBuilder` session
   on the card, queries `cb_filter`, `cb_like` (a string LIKE: verdicts
   over FSST dictionaries, gathered by code) and `tpch_q6`; answers
   checked against pyarrow on the same parquet (`bench/oracle.py`:
   integers exact, floats rtol 1e-9); the fused scalar route and one K1
   launch per interval predicate (`K1_PER_RUN`) checked through the
   port's counters, which are set to 0 just before this phase and read
   after;
6. the grouped main path on the same session: `cb_groupby`, `cb_q15`,
   `tpch_q15_revenue`, `tpch_supp_price` and `tpch_q1` (string group
   keys by vocabulary id); answers checked the same way; the grouped
   route, K1 (one launch per interval predicate), K2 and their counters
   checked, counts set to 0 just before this phase and read after; the
   slot and column list the path fed K2 are captured by wrapping the
   wrapper from here;
   6b. the star path on the same session: TPC-H q3 (the bench's text),
   q5, q10, q12 and q14 (CASE sums) at this run's scale over `lineitem`,
   `orders`, `customer`, `supplier`, `nation`, `region` and `part`;
   answers checked against pyarrow
   joins (`bench/oracle.py`), the first run's answer and the last warm
   run's; the star route (`STATS["star_queries"]`), the first run
   (dimension builds and the uniqueness fetch) and the best of three
   warm runs timed, K1 launches per warm run asserted (`K1_PER_RUN`:
   the fact table's intervals only, since warm runs reuse the cached
   star plan) and in the first run (`K1_FIRST_RUN`, the builds'
   intervals added); the dimension index tables and the reduction
   tiers a warm run took (`hashagg.TIERS`) reported; every (planes, lo,
   hi) the star runs give K1 captured by wrapping the wrapper from
   here; counts set to 0 just before this phase and read after;
   6c. the rest of the single-table slice on the hits session: ClickBench
   q4, q5, q8, q9, q10, q11, q13, q18, q22, q24, q26 and q42 as written
   in `benchmark/clickbench/queries/`, `cb_q42_open` (q42 without its
   CounterID / EventDate conjuncts and OFFSET: the generator has no row
   with CounterID = 62, and its two interval predicates launch K1), and
   one query each for the chained and host-fold count(DISTINCT) forms;
   answers checked against pyarrow under the tie rule of a LIMIT cut,
   the route (`distinct_sort`, `distinct_chained`, `distinct_fold`,
   `fused_selects`, `fused_grouped`) and K1 launches per warm run
   asserted, the first run and the best of three warm runs timed; counts
   set to 0 just before this phase and read after;
   6d. TPC-H's multi-table queries on the star phase's session at this
   run's scale, `partsupp` added: q4, q7, q8, q9, q11, q16, q18, q21 and
   q22 as `liquid_tpu_torch/bench/tpch_queries.py` gives them (views and
   derived tables inlined, uncorrelated subqueries as literals,
   existence probes, aliased relations, q9's composite key); answers
   (first run and last warm run) checked against pyarrow under the tie
   rule of a LIMIT cut, the route counters (`star_queries`,
   `fused_queries`) and K1 launches per warm run and in the first run
   asserted (`K1_PER_RUN`, `K1_FIRST_RUN`), the first run and the best
   of three warm runs timed; counts set to 0 just before this phase and
   read after;
   6e. the classic path on the same session: TPC-H q2, q13, q15 (its
   view, as three statements), q17 and q20 at this run's scale, and
   ClickBench q19, q23 and q39 on the hits rows (`classic_queries`);
   answers (first run and last warm run) checked against pyarrow (the
   tie rule where a LIMIT cuts), the classic counter of `exec.STATS`
   asserted per run, K1's single-form launches per run equal to
   `classic_k1_per_run` in every run; in the phase, at least
   one sort-merge join on the card (`device_join.STATS`), one grouped
   device aggregation (`device_agg.STATS`) and one single-form K1
   launch; the first run and the best of three warm runs timed, and the
   device time of the joins' sorts and probes (CUDA events around the
   `ops/join.py` calls); every (planes, constants) the runs gave K1's
   single form captured by wrapping the wrapper from here; counts set
   to 0 just before this phase and read after;
7. K1's interval form checked bit-exact against its plain version and
   timed (CUDA events, L2 flushed before each timed call) on the exact
   (planes, lo, hi) the main path gave it -- the single-table plans'
   and the star phase's, dimension builds included -- beside the two
   single-constant launches it replaces (as a pair after one flush, and
   one alone), the plain version and the byte bound; its single form
   checked bit-exact on every input phase 6e captured and the largest
   timed beside its plain version and byte bound (`time_k1_single`);
8. K2 timed the same way on the inputs captured in phase 6, beside its
   plain version, one `index_add_` call on the same
   inputs (stacked to int64 outside the timing) and its byte bound, with
   the bytes its CTAs' flush adds into the output;
9. one warm run of each query (phases 6c's, 6d's and 6e's too) under
   torch.profiler:
   device-busy time,
   the device's idle share, the device operations that took longest and
   the concatenation copies (`Cat` kernels, the form `torch.stack` takes);
   for `cb_q24` and `cb_q26` one more warm run under cProfile splits the
   fused select's host time by step (`host_split`);
   9b. the port's benchmark entry point (`liquid_tpu_torch.bench.main`)
   in this process at this run's sizes, counts set to 0 just before and
   read after: six queries answered and checked against pyarrow, routes
   fused and (`tpch_q3`) star, the micro line's K3 launches (at least
   256); its JSON line is
   printed by it.  The launches of its operator timing loops are
   counted apart: each kernel's `launches` is the query phases' and the
   micro line's, `launches_by_phase` splits it and adds the loops';
10. K3 and K4 timed (CUDA events, L2 flushed) on the micro line's input,
   w = 10 over 2^27 rows, beside their plain versions and byte bounds.

The last lines are the card's name and power limit, a {"kernels": [...]}
JSON line, and {"ok": true, "device": {...}}.  `--trash-band NAME` runs
none of the phases: it times the grouped scatters of one tree
(`trash_band`) and prints one JSON line.  Data is cached as parquet
under the temporary directory; nothing else outside the checkout is
touched.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and the FP32
#: non-tensor rate used as the rate of 32-bit integer word operations
HBM_BYTES_PER_S = 3.35e12
WORD_OPS_PER_S = 67e12

CB_FILTER = 'SELECT COUNT(*) FROM hits WHERE "AdvEngineID" <> 0'
CB_GROUPBY = ('SELECT "RegionID", SUM("AdvEngineID"), COUNT(*) AS c, '
              'AVG("ResolutionWidth") FROM hits GROUP BY "RegionID" '
              'ORDER BY c DESC, "RegionID" LIMIT 10')
CB_Q15 = ('SELECT "UserID", COUNT(*) FROM hits GROUP BY "UserID" '
          'ORDER BY COUNT(*) DESC, "UserID" LIMIT 10')
TPCH_Q15_REVENUE = """SELECT l_suppkey, sum(l_extendedprice * (1 - l_discount))
 AS total_revenue FROM lineitem WHERE l_shipdate >= date '1996-01-01'
 AND l_shipdate < date '1996-04-01' GROUP BY l_suppkey ORDER BY l_suppkey"""
#: Q1's sum_base_price and count_order per supplier: the wide (hi/lo) K2
#: form at SF1 (the revenue product's bound is too wide for the gates)
TPCH_SUPP_PRICE = """SELECT l_suppkey, sum(l_extendedprice) AS sum_base_price,
 count(*) AS count_order FROM lineitem WHERE l_shipdate <= date '1998-09-02'
 GROUP BY l_suppkey ORDER BY l_suppkey"""
CB_LIKE = 'SELECT COUNT(*) FROM hits WHERE "URL" LIKE \'%yandex%\''
TPCH_Q1 = """SELECT l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
 sum(l_extendedprice) as sum_base_price,
 sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
 sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
 avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
 avg(l_discount) as avg_disc, count(*) as count_order
 FROM lineitem WHERE l_shipdate <= date '1998-09-02'
 GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""
TPCH_Q1_COLS = ["l_returnflag", "l_linestatus", "l_quantity",
                "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
TPCH_Q6 = """SELECT sum(l_extendedprice * l_discount) as revenue
 FROM lineitem WHERE l_shipdate >= date '1994-01-01'
 AND l_shipdate < date '1995-01-01'
 AND l_discount between 0.05 and 0.07 AND l_quantity < 24"""
#: TPC-H q3 as the bench runs it (ties broken by l_orderkey), q5, and q10
#: with ties broken by c_custkey
TPCH_Q3 = """SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount))
 as revenue, o_orderdate, o_shippriority
 FROM customer, orders, lineitem
 WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
 AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
 AND l_shipdate > date '1995-03-15'
 GROUP BY l_orderkey, o_orderdate, o_shippriority
 ORDER BY revenue desc, o_orderdate, l_orderkey LIMIT 10"""
TPCH_Q5 = """SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
 FROM customer, orders, lineitem, supplier, nation, region
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
 AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
 AND r_name = 'ASIA' AND o_orderdate >= date '1994-01-01'
 AND o_orderdate < date '1994-01-01' + interval '1' year
 GROUP BY n_name ORDER BY revenue DESC"""
TPCH_Q10 = """SELECT c_custkey, c_name,
 sum(l_extendedprice * (1 - l_discount)) AS revenue,
 c_acctbal, n_name, c_address, c_phone, c_comment
 FROM customer, orders, lineitem, nation
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND o_orderdate >= date '1993-10-01'
 AND o_orderdate < date '1993-10-01' + interval '3' month
 AND l_returnflag = 'R' AND c_nationkey = n_nationkey
 GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
 c_comment ORDER BY revenue DESC, c_custkey LIMIT 20"""
#: (query, sql, {table: columns}) of the star phase
STAR_QUERIES = [
    ("tpch_q3", TPCH_Q3, {
        "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                     "l_shipdate"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                   "o_shippriority"],
        "customer": ["c_custkey", "c_mktsegment"]}),
    ("tpch_q5", TPCH_Q5, {
        "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "customer": ["c_custkey", "c_nationkey"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "nation": ["n_nationkey", "n_name", "n_regionkey"],
        "region": ["r_regionkey", "r_name"]}),
    ("tpch_q10", TPCH_Q10, {
        "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                     "l_returnflag"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "customer": ["c_custkey", "c_name", "c_acctbal", "c_phone",
                     "c_address", "c_comment", "c_nationkey"],
        "nation": ["n_nationkey", "n_name"]}),
]


TPCH_Q12 = """SELECT l_shipmode,
 sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
 then 1 else 0 end) as high_line_count,
 sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
 then 1 else 0 end) as low_line_count
 FROM orders, lineitem WHERE o_orderkey = l_orderkey
 AND l_shipmode in ('MAIL', 'SHIP') AND l_commitdate < l_receiptdate
 AND l_shipdate < l_commitdate AND l_receiptdate >= date '1994-01-01'
 AND l_receiptdate < date '1994-01-01' + interval '1' year
 GROUP BY l_shipmode ORDER BY l_shipmode"""
TPCH_Q14 = """SELECT 100.00 * sum(case when p_type like 'PROMO%'
 then l_extendedprice * (1 - l_discount) else 0 end)
 / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
 FROM lineitem, part WHERE l_partkey = p_partkey
 AND l_shipdate >= date '1995-09-01'
 AND l_shipdate < date '1995-09-01' + interval '1' month"""
STAR_QUERIES += [
    ("tpch_q12", TPCH_Q12, {
        "lineitem": ["l_orderkey", "l_shipmode", "l_shipdate",
                     "l_commitdate", "l_receiptdate"],
        "orders": ["o_orderkey", "o_orderpriority"]}),
    ("tpch_q14", TPCH_Q14, {
        "lineitem": ["l_partkey", "l_extendedprice", "l_discount",
                     "l_shipdate"],
        "part": ["p_partkey", "p_type"]}),
]

#: phase 6c: (name, ClickBench query number or SQL, the route counter of
#: `fused_agg.STATS` that must move by one, columns to transcode first).
#: The numbered ones are read from `benchmark/clickbench/queries/`.
#: `cb_q42_open` is q42 without its CounterID and EventDate conjuncts and
#: OFFSET (the generator has no row with CounterID = 62); the last two
#: reach the distinct forms the data does not reach on its own: an
#: expression key has no cardinality bound (the chained two-level hash),
#: two DISTINCT columns fold on the host
CB_Q42_OPEN = ('SELECT DATE_TRUNC(\'minute\', to_timestamp_seconds('
               '"EventTime")) AS M, COUNT(*) AS PageViews FROM hits WHERE '
               '"IsRefresh" = 0 AND "DontCountHits" = 0 GROUP BY DATE_TRUNC('
               '\'minute\', to_timestamp_seconds("EventTime")) ORDER BY '
               'DATE_TRUNC(\'minute\', M) LIMIT 10')
CB_DISTINCT_CHAINED = ('SELECT "RegionID" + 1 AS r, COUNT(DISTINCT "UserID") '
                       'AS u FROM hits GROUP BY "RegionID" + 1 '
                       'ORDER BY u DESC, r LIMIT 10')
CB_DISTINCT_FOLD = ('SELECT "TraficSourceID", COUNT(DISTINCT "SearchEngineID")'
                    ' AS e, COUNT(DISTINCT "AdvEngineID") AS a, COUNT(*) AS c '
                    'FROM hits GROUP BY "TraficSourceID" '
                    'ORDER BY c DESC, "TraficSourceID"')
SLICE_QUERIES = [
    ("cb_q4", 4, "distinct_sort", ["UserID"]),
    ("cb_q5", 5, "distinct_sort", ["SearchPhrase"]),
    ("cb_q8", 8, "distinct_sort", ["RegionID", "UserID"]),
    ("cb_q9", 9, "distinct_sort", ["RegionID", "AdvEngineID",
                                   "ResolutionWidth", "UserID"]),
    ("cb_q10", 10, "distinct_sort", ["MobilePhoneModel", "UserID"]),
    ("cb_q11", 11, "distinct_sort", ["MobilePhone", "MobilePhoneModel",
                                     "UserID"]),
    ("cb_q13", 13, "distinct_sort", ["SearchPhrase", "UserID"]),
    ("cb_q18", 18, "fused_grouped", ["UserID", "EventTime", "SearchPhrase"]),
    ("cb_q22", 22, "distinct_sort", ["SearchPhrase", "URL", "Title",
                                     "UserID"]),
    ("cb_q24", 24, "fused_selects", ["SearchPhrase", "EventTime"]),
    ("cb_q26", 26, "fused_selects", ["SearchPhrase", "EventTime"]),
    ("cb_q42", 42, "fused_grouped", ["EventTime", "CounterID", "EventDate",
                                     "IsRefresh", "DontCountHits"]),
    ("cb_q42_open", CB_Q42_OPEN, "fused_grouped",
     ["EventTime", "IsRefresh", "DontCountHits"]),
    ("cb_distinct_chained", CB_DISTINCT_CHAINED, "distinct_chained",
     ["RegionID", "UserID"]),
    ("cb_distinct_fold", CB_DISTINCT_FOLD, "distinct_fold",
     ["TraficSourceID", "SearchEngineID", "AdvEngineID"]),
]
#: phase 6d: TPC-H's multi-table queries as `bench/tpch_queries.py` gives
#: them -- (name, query number, {route counter of `fused_agg.STATS`: its
#: move per run}, {table: columns to transcode first}).  q11 runs a star
#: query inside its own HAVING, q18 and q22 a fused aggregate inside WHERE,
#: q16 a fused bare SELECT inside NOT IN
MULTI_QUERIES = [
    ("tpch_q4", 4, {"fused_queries": 1, "star_queries": 0}, {
        "orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
        "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]}),
    ("tpch_q7", 7, {"fused_queries": 0, "star_queries": 1}, {
        "supplier": ["s_suppkey", "s_nationkey"],
        "lineitem": ["l_orderkey", "l_suppkey", "l_shipdate",
                     "l_extendedprice", "l_discount"],
        "orders": ["o_orderkey", "o_custkey"],
        "customer": ["c_custkey", "c_nationkey"],
        "nation": ["n_nationkey", "n_name"]}),
    ("tpch_q8", 8, {"fused_queries": 0, "star_queries": 1}, {
        "part": ["p_partkey", "p_type"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "lineitem": ["l_partkey", "l_suppkey", "l_orderkey",
                     "l_extendedprice", "l_discount"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate"],
        "customer": ["c_custkey", "c_nationkey"],
        "nation": ["n_nationkey", "n_regionkey", "n_name"],
        "region": ["r_regionkey", "r_name"]}),
    ("tpch_q9", 9, {"fused_queries": 0, "star_queries": 1}, {
        "part": ["p_partkey", "p_name"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "lineitem": ["l_suppkey", "l_partkey", "l_orderkey",
                     "l_extendedprice", "l_discount", "l_quantity"],
        "partsupp": ["ps_suppkey", "ps_partkey", "ps_supplycost"],
        "orders": ["o_orderkey", "o_orderdate"],
        "nation": ["n_nationkey", "n_name"]}),
    ("tpch_q11", 11, {"fused_queries": 0, "star_queries": 2}, {
        "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost",
                     "ps_availqty"],
        "supplier": ["s_suppkey", "s_nationkey"],
        "nation": ["n_nationkey", "n_name"]}),
    ("tpch_q16", 16, {"fused_queries": 1, "star_queries": 1}, {
        "partsupp": ["ps_partkey", "ps_suppkey"],
        "part": ["p_partkey", "p_brand", "p_type", "p_size"],
        "supplier": ["s_suppkey", "s_comment"]}),
    ("tpch_q18", 18, {"fused_queries": 1, "star_queries": 1}, {
        "customer": ["c_custkey", "c_name"],
        "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                   "o_totalprice"],
        "lineitem": ["l_orderkey", "l_quantity"]}),
    ("tpch_q21", 21, {"fused_queries": 0, "star_queries": 1}, {
        "supplier": ["s_suppkey", "s_name", "s_nationkey"],
        "lineitem": ["l_orderkey", "l_suppkey", "l_receiptdate",
                     "l_commitdate"],
        "orders": ["o_orderkey", "o_orderstatus"],
        "nation": ["n_nationkey", "n_name"]}),
    ("tpch_q22", 22, {"fused_queries": 2, "star_queries": 0}, {
        "customer": ["c_custkey", "c_phone", "c_acctbal"],
        "orders": ["o_custkey"]}),
]


def multi_sql(qid: int) -> str:
    from liquid_tpu_torch.bench.tpch_queries import QUERIES
    return QUERIES[qid]


#: phase 6e: the classic path -- (name, its SQL (a statement list for
#: q15's view), the classic counter of `exec.STATS` its run moves).  TPC-H
#: q2 and q20 are bare SELECTs over joins, q13 an aggregate over a
#: derived table with a left join inside, q15 a join with an aggregate
#: view, q17 a join with a correlated scalar lookup; ClickBench q19 is a
#: bare SELECT the fused select passes on (UserID's 64 planes), q23
#: SELECT *, q39 a string-valued CASE key
def classic_queries():
    from liquid_tpu_torch.bench.tpch_queries import QUERIES
    return [("tpch_q2", QUERIES[2], "classic_joins"),
            ("tpch_q13", QUERIES[13], "classic_joins"),
            ("tpch_q15", QUERIES[15], "classic_joins"),
            ("tpch_q17", QUERIES[17], "classic_joins"),
            ("tpch_q20", QUERIES[20], "classic_joins"),
            ("cb_q19", slice_sql(19), "classic_selects"),
            ("cb_q23", slice_sql(23), "classic_selects"),
            ("cb_q39", slice_sql(39), "classic_aggregates")]


def classic_k1_per_run(ctx) -> dict:
    """K1 single-form launches (`bitpack_cuda.cmp_const_many`) per run of
    each phase-6e query: one per row group x pushdown predicate x width
    bucket of two or more blocks (no zone map here prunes a row group's
    blocks below two).  q2: part's p_size = 15 and the dynamic ps_suppkey
    range on partsupp (ps_partkey is linear-coded: decoded and compared);
    q19: UserID's equality, per hits row group.  The others filter on
    strings, IN lists, linear-coded keys (q17's part takes lineitem's
    l_partkey range on its sorted p_partkey) or zone maps alone."""
    def rgs(name):
        return ctx._tables[name].num_row_groups
    out = {q: 0 for q, _s, _c in classic_queries()}
    out.update(tpch_q2=rgs("part") + rgs("partsupp"), cb_q19=rgs("hits"))
    return out


def run_statements(ctx, sql):
    """A query's answer: a statement list runs whole and answers with its
    SELECT."""
    out = None
    for stmt in (sql if isinstance(sql, list) else [sql]):
        got = ctx.sql(stmt).to_arrow()
        if stmt.strip().lower().startswith("select"):
            out = got
    return out


#: the route counters phase 6c reads
SLICE_ROUTES = ("distinct_sort", "distinct_chained", "distinct_fold",
                "fused_selects", "fused_grouped")


def slice_sql(query) -> str:
    """A phase-6c query's SQL: a ClickBench file's text, or the SQL."""
    if isinstance(query, str):
        return query
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmark", "clickbench", "queries", f"q{query}.sql")
    with open(path) as f:
        return f.read().strip().rstrip(";")


#: K1 launches per warm run: one per interval predicate on a bit-plane
#: column (string predicates are verdict LUTs and launch none).  A star
#: query's warm run reuses its cached plan and dimension builds: only
#: the fact table's intervals launch -- q3's l_shipdate, q5's dynamic
#: l_suppkey range (two), none for q10 (l_returnflag is a string; the
#: dynamic l_orderkey range is linear-coded, a residual)
K1_PER_RUN = {"cb_filter": 1, "cb_like": 0, "tpch_q6": 5, "cb_groupby": 0,
              "cb_q15": 0, "tpch_q15_revenue": 2, "tpch_supp_price": 1,
              "tpch_q1": 1, "tpch_q3": 1, "tpch_q5": 2, "tpch_q10": 0,
              # l_receiptdate's two bounds (l_shipmode is a string); q14's
              # l_shipdate bounds and the dynamic l_partkey range
              "tpch_q12": 2, "tpch_q14": 4,
              # phase 6c: only cb_q42_open's IsRefresh and DontCountHits
              # are intervals (q42's CounterID = 62 prunes every block;
              # the others filter on strings or not at all)
              **{q: 0 for q, *_rest in SLICE_QUERIES}, "cb_q42_open": 2,
              # phase 6d: q4's o_orderdate bounds (its existence build's
              # l_commitdate < l_receiptdate is a residual); q7's
              # l_shipdate bounds and a dynamic l_suppkey range; q8's
              # dynamic l_partkey and l_suppkey ranges; q9's dynamic
              # l_partkey range twice (part, partsupp) and l_suppkey; q11's
              # dynamic ps_suppkey range in the outer and the HAVING
              # query; q21's dynamic l_suppkey range; q22's c_acctbal > 0
              # (the scalar subquery) and > its value.  q16 and q18 filter
              # on strings, an IN list and linear-coded keys: none
              "tpch_q4": 2, "tpch_q7": 4, "tpch_q8": 4, "tpch_q9": 6,
              "tpch_q11": 4, "tpch_q16": 0, "tpch_q18": 0, "tpch_q21": 2,
              "tpch_q22": 2}
#: K1 launches in a star query's first run, in the phase's order: the
#: warm run's plus the intervals of its dimension builds (each query
#: builds orders under its own o_orderdate range; q12's orders and q14's
#: part carry no predicate)
K1_FIRST_RUN = {"tpch_q3": 2, "tpch_q5": 4, "tpch_q10": 2, "tpch_q12": 2,
                "tpch_q14": 4,
                # phase 6d: q8 builds orders under its o_orderdate range;
                # the other builds carry no interval predicate
                "tpch_q4": 2, "tpch_q7": 4, "tpch_q8": 6, "tpch_q9": 6,
                "tpch_q11": 4, "tpch_q16": 0, "tpch_q18": 0, "tpch_q21": 2,
                "tpch_q22": 2}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def k1_bytes(bsz: int, width: int) -> int:
    """Bytes K1's interval form must move: planes and both constants read
    once, the mask written."""
    return bsz * width * 256 * 4 + 2 * bsz * 8 + bsz * 256 * 4


def k1_bound_ms(bsz: int, width: int):
    """(least time in ms, what bounds it): bytes over HBM bandwidth vs
    ~10 word operations per plane per output word (two compares) over
    the word rate."""
    t_bytes = k1_bytes(bsz, width) / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * width * bsz * 256 / WORD_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_sass_atomics(lib: str) -> list:
    """Phase 2: the shared-memory atomic opcodes in K2's SASS; raises on
    a CAS loop (ATOMS.CAS / ATOMS.CAST.SPIN), which would mean the
    kernel's table adds are emulated."""
    import re
    from liquid_tpu_torch.ops import nvcc
    cuobjdump = os.path.join(os.path.dirname(nvcc._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    ops = sorted(set(re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", sass)))
    if not ops or any("CAS" in op for op in ops):
        raise AssertionError(f"K2's shared atomics are not native: {ops}")
    return ops


def time_cold(torch, fn, flush, iters: int) -> float:
    """Median ms of one call, L2 flushed (a 256 MB write) before each.
    A device-side wait of about 0.5 ms after the flush lets the host
    enqueue the call before the start event is reached, so host time
    between launches (a call of two launches) is not timed."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_warm(torch, fn, iters: int) -> float:
    """Mean ms per call over back-to-back calls (inputs L2-resident)."""
    for _ in range(3):
        fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def _max_abs_err(torch, got, ref) -> int:
    return max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
               for g, r in zip(got, ref))


def check_k1(torch, dev) -> int:
    """Phase 3: kernel vs plain version, bit-exact -> max abs error (0)."""
    import numpy as np
    from liquid_tpu_torch.ops import bitpack as bp
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    gen = torch.Generator(device=dev).manual_seed(1234)
    rng = np.random.default_rng(1234)
    worst = 0
    for width in bp.WIDTH_BUCKETS[1:]:
        top = (1 << width) - 1
        for bsz in (1, 3, 489, 4097):
            planes = torch.randint(-2 ** 31, 2 ** 31, (bsz, width, 256),
                                   dtype=torch.int32, device=dev,
                                   generator=gen)
            pool = [0, 1, top, int(rng.integers(0, min(top, 1 << 62) + 1)),
                    (1 << 64) - 1]
            if width < 64:
                pool += [1 << width, (1 << 63) | top]
            cs = [pool[i] if i < len(pool)
                  else pool[int(rng.integers(len(pool)))]
                  for i in range(bsz)]
            if bsz == 1:
                cs = [pool[width % len(pool)]]
            cs_t = torch.from_numpy(np.array(cs, np.uint64).view(np.int64)
                                    ).to(dev)
            got = k1.cmp_const_many(planes, cs_t)
            ref = k1.cmp_const_many_ref(planes, cs_t)
            # interval form: hi is lo's constants in another order, so
            # lo <= hi, lo > hi and bounds beyond the width all occur
            hi_t = cs_t[torch.randperm(bsz, device=dev, generator=gen)]
            ref_iv = k1.in_interval_many_ref(planes, cs_t, hi_t)
            got_iv = k1.in_interval_many(planes, cs_t, hi_t)
            torch.cuda.synchronize()
            err = max(_max_abs_err(torch, got, ref),
                      _max_abs_err(torch, [got_iv], [ref_iv]))
            if err:
                raise AssertionError(f"K1 != plain at width {width}, "
                                     f"B {bsz}: max abs err {err}")
            worst = max(worst, err)
    return worst


def k2_bytes(n: int, cols: int, m: int) -> int:
    """Bytes K2 must move: slots and values read once, the table written."""
    return 4 * n + 4 * n * cols + 8 * (m + 1) * cols


def k2_flush_bytes(torch, slot, cols, m: int) -> tuple:
    """(bytes, most bytes) K2's CTAs add into the output at their end
    under the wrapper's plan: 8 per non-zero table entry, counted from
    each row chunk's own sums; at most 8 (m + 1) per (chunk, column)."""
    from liquid_tpu_torch.ops import grouphist as gh
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    n = slot.shape[0]
    p = k2.plan(n, len(cols), m, torch.cuda.get_device_properties(
        slot.device).multi_processor_count)
    nz = 0
    for q in range(p.chunks):
        r0 = 4 * q * p.quads_per_chunk
        r1 = n if q == p.chunks - 1 else 4 * (q + 1) * p.quads_per_chunk
        part = gh.group_accumulate_ref(slot[r0:r1], [c[r0:r1] for c in cols],
                                       m)
        nz += int((part != 0).sum())
    return 8 * nz, 8 * (m + 1) * len(cols) * p.chunks


def k2_bound_ms(n: int, cols: int, m: int):
    """(least time in ms, what bounds it): bytes over HBM bandwidth vs one
    64-bit add per value over the word rate."""
    t_bytes = k2_bytes(n, cols, m) / HBM_BYTES_PER_S * 1e3
    t_ops = n * cols / WORD_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_k2(torch, dev) -> int:
    """Phase 4: K2 vs plain version, bit-exact -> max abs error (0)."""
    import numpy as np
    from liquid_tpu_torch.ops import grouphist as gh
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    gen = torch.Generator(device=dev).manual_seed(4321)
    rng = np.random.default_rng(4321)
    worst = 0
    for n in (2048, 4097, 4_005_888, 4_005_891):
        for m in (1, 63, 8889, 16385, 65535):
            uniform = torch.randint(0, m + 1, (n,), dtype=torch.int32,
                                    device=dev, generator=gen)
            # zipf(1.3) as prepare_hits draws RegionID
            skewed = torch.from_numpy(
                (rng.zipf(1.3, n) % (m + 1)).astype(np.int32)).to(dev)
            for slot in (uniform, skewed):
                # 1 % negative slots (trash row), 1 % beyond m (clipped
                # to mp - 1, dropped past m)
                pick = torch.rand(n, device=dev, generator=gen)
                odd = torch.randint(1, 40, (n,), dtype=torch.int32,
                                    device=dev, generator=gen)
                slot = torch.where(pick < 0.01, -odd, slot)
                slot = torch.where(pick > 0.99, m + odd, slot).contiguous()
                for ncols in (1, 4, 7, 16):
                    cols = [torch.randint(-2 ** 31, 2 ** 31, (n,),
                                          dtype=torch.int32, device=dev,
                                          generator=gen)
                            for _ in range(ncols)]
                    ref = gh.group_accumulate_ref(slot, cols, m)
                    got = k2.group_accumulate(slot, cols, m)
                    torch.cuda.synchronize()
                    err = int((got - ref).abs().max())
                    if n == 4097 and ncols == 4:
                        # a column 4 bytes off the 16-byte loads' alignment
                        try:
                            k2.group_accumulate(slot[1:], [c[1:] for c in cols],
                                                m)
                        except ValueError:
                            pass
                        else:
                            raise AssertionError("K2 took a misaligned column")
                    if err:
                        raise AssertionError(
                            f"K2 != plain at n {n}, m {m}, C {ncols}: "
                            f"max abs err {err}")
                    worst = max(worst, err)
    return worst


def check_k34(torch, dev) -> int:
    """Phase 4b: K3 and K4 vs their plain versions, bit-exact, flat and
    prepped planes -> max abs error (0)."""
    import numpy as np
    from liquid_tpu_torch.ops import bitpack_cuda as k
    gen = torch.Generator(device=dev).manual_seed(3434)
    rng = np.random.default_rng(3434)
    worst = 0
    for n_words in (256, 4096, 1 << 22):
        for width in range(65):
            planes = torch.randint(-2 ** 31, 2 ** 31, (width, n_words),
                                   dtype=torch.int32, device=dev,
                                   generator=gen)
            top = (1 << width) - 1
            consts = {0, 1, top, int(rng.integers(0, top + 1,
                                                  dtype=np.uint64)),
                      (1 << 64) - 1}
            if width < 64:
                consts |= {1 << width, top + 1 + int(rng.integers(1 << 20)),
                           (1 << 63) | top}
            for c in sorted(consts):
                ref = ((k.count_gt_ref(planes, c),)
                       + k.cmp_const_planes_ref(planes, c))
                for form in (planes, k.prep(planes)):
                    got = (k.count_gt(form, c),) + k.cmp_const_planes(form, c)
                    torch.cuda.synchronize()
                    err = _max_abs_err(torch, got, ref)
                    if err:
                        raise AssertionError(
                            f"K3/K4 != plain at width {width}, W {n_words}, "
                            f"c {c}: max abs err {err}")
                    worst = max(worst, err)
    return worst


def k34_bound_ms(width: int, n_words: int, outputs: int):
    """(least time in ms, what bounds it) for K3 (outputs 0: one scalar)
    or K4 (outputs 2: lt and eq): planes read once, outputs written, vs
    ~5 word operations per plane per word over the word rate."""
    nbytes = 4 * width * n_words + (4 * outputs * n_words or 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * width * n_words / WORD_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def time_k34(torch) -> dict:
    """Phase 10: K3 and K4 timed (CUDA events, L2 flushed) on the micro
    line's input -- w = 10 over 2^27 rows, uniform values, seed 0 --
    beside their plain versions and byte bounds."""
    import numpy as np
    from liquid_tpu_torch.bench import main as bench
    from liquid_tpu_torch.device import words_to_tensor
    from liquid_tpu_torch.ops import bitpack_cuda as k
    rows = 1 << 27
    rng = np.random.default_rng(0)
    planes = words_to_tensor(rng.integers(
        0, 1 << 32, (bench.MICRO_WIDTH, rows // 32), dtype=np.uint32), "cuda")
    tiles = k.prep(planes)
    c = int(rng.integers(1, 1 << bench.MICRO_WIDTH))
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    got = (k.count_gt(tiles, c),) + k.cmp_const_planes(tiles, c)
    ref = (k.count_gt_ref(planes, c),) + k.cmp_const_planes_ref(planes, c)
    err = _max_abs_err(torch, got, ref)
    if err:
        raise AssertionError(f"K3/K4 != plain on the micro input: {err}")
    out = {}
    for name, fn, plain, outputs in (
            ("count_gt", lambda: k.count_gt(tiles, c),
             lambda: k.count_gt_ref(planes, c), 0),
            ("cmp_const_planes", lambda: k.cmp_const_planes(tiles, c),
             lambda: k.cmp_const_planes_ref(planes, c), 2)):
        bound, by, nbytes = k34_bound_ms(bench.MICRO_WIDTH, rows // 32,
                                         outputs)
        row = dict(w=bench.MICRO_WIDTH, rows=rows, c=c, bytes=nbytes,
                   ms=time_cold(torch, fn, flush, 50),
                   warm_ms=time_warm(torch, fn, 100),
                   plain_ms=time_cold(torch, plain, flush, 10),
                   bound_ms=bound, bound_by=by, max_abs_err=err)
        out[name] = row
        log(f"[k34] {name}: {json.dumps(row)}")
    return out


def run_harness(torch, args):
    """Phase 9b: the port's benchmark entry point, in this process, at
    this run's data sizes; its JSON line is printed by it on stdout.
    -> (its result, the launches of its operator timing loops, which
    are kept apart from the launches its queries and micro line make)."""
    from liquid_tpu_torch.bench import main as bench
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    op_launches = {}
    timed = bench.operator_rooflines

    def counted(ctx):
        before = {**k1.LAUNCHES, **k2.LAUNCHES}
        try:
            return timed(ctx)
        finally:
            op_launches.update({k: v - before[k] for k, v in
                                {**k1.LAUNCHES, **k2.LAUNCHES}.items()})

    bench.operator_rooflines = counted
    try:
        res = bench.main(["--data-dir", args.data_dir,
                          "--hits-rows", str(args.hits_rows), "--sf",
                          str(args.sf)])
    finally:
        bench.operator_rooflines = timed
    want = {"cb_filter", "cb_groupby", "cb_like", "tpch_q1", "tpch_q6"}
    if set(res["queries_ms"]) != want | {"tpch_q3"}:
        raise AssertionError(f"harness answered {sorted(res['queries_ms'])}")
    if res["routes"] != {**{q: "fused" for q in want}, "tpch_q3": "star"}:
        raise AssertionError(f"harness routes {res['routes']}")
    if res["micro_packed_compare_rows_per_s"] is None:
        raise AssertionError("harness micro line gave no rate")
    if set(res["not_ported"]) != {"arrow"}:
        raise AssertionError(f"harness not_ported {res['not_ported']}")
    return res, op_launches


def run_main_path(torch, paths: dict, expect: dict, builder):
    """Phase 5: build a session from `builder` and run the scalar queries
    -> (session, per-query report)."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.sql import fused_agg
    queries = [("cb_filter", "hits", ["AdvEngineID"], CB_FILTER),
               ("cb_like", "hits", ["URL"], CB_LIKE),
               ("tpch_q6", "lineitem", ["l_extendedprice", "l_discount",
                                        "l_shipdate", "l_quantity"], TPCH_Q6)]
    ctx, _cache = builder.with_max_memory_bytes(16 << 30).build()
    for name, p in paths.items():
        ctx.register_parquet(name, p)
    report = {}
    for qname, table, cols, sql in queries:
        pt = ctx._tables[table]
        t0 = time.perf_counter()
        for rg in range(pt.num_row_groups):
            for c in cols:
                pt.ensure_cached(rg, c)
        t_transcode = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()

        def run_once():
            before = fused_agg.STATS["fused_scalar"]
            launches = k1.LAUNCHES["cmp_const_many"]
            out = ctx.sql(sql).to_arrow()
            torch.cuda.synchronize()
            if fused_agg.STATS["fused_scalar"] != before + 1:
                raise AssertionError(f"{qname} left the fused scalar route")
            return out, k1.LAUNCHES["cmp_const_many"] - launches

        t0 = time.perf_counter()
        out, _ = run_once()
        t_first = time.perf_counter() - t0
        warm, per_run = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out, per_run = run_once()
            warm.append(time.perf_counter() - t0)
        value = out.column(0)[0].as_py()
        want = expect[qname][0][0].as_py()
        if not oracle.same_table(out, expect[qname]):
            raise AssertionError(f"{qname}: port {value!r} != pyarrow {want!r}")
        if per_run != K1_PER_RUN[qname]:
            raise AssertionError(f"{qname}: {per_run} K1 launches per run, "
                                 f"expected {K1_PER_RUN[qname]}")
        report[qname] = dict(
            rows=pt.num_rows, blocks=sum(pt.num_batches(rg) for rg in
                                         range(pt.num_row_groups)),
            answer=value, expected=want, transcode_s=t_transcode,
            first_run_s=t_first, warm_best_ms=min(warm) * 1e3,
            warm_ms=[w * 1e3 for w in warm], k1_launches_per_run=per_run,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[main] {qname}: {json.dumps(report[qname])}")
    return ctx, report


def run_grouped_path(torch, ctx, paths: dict, expect: dict):
    """Phase 6: the grouped queries on the session -> (per-query report,
    {query: (slot, cols, m)} as the path last fed K2)."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    from liquid_tpu_torch.sql import fused_agg
    # takes K2: True / False asserted; None reported only.  The revenue
    # product's bound makes its K2 plan need seg = 8, and the TPU-era
    # partials-bytes gate (nseg * (m + 8) * 512 <= 2 GiB, kept for route
    # parity) then depends on the row count: SF1 (3.08 GB) keeps the
    # scatter tier, smaller scales take K2.
    queries = [("cb_groupby", "hits", ["RegionID", "AdvEngineID",
                                       "ResolutionWidth"], CB_GROUPBY, True),
               ("cb_q15", "hits", ["UserID"], CB_Q15, False),
               ("tpch_q15_revenue", "lineitem",
                ["l_suppkey", "l_extendedprice", "l_discount",
                 "l_shipdate"], TPCH_Q15_REVENUE, None),
               ("tpch_supp_price", "lineitem",
                ["l_suppkey", "l_extendedprice", "l_shipdate"],
                TPCH_SUPP_PRICE, True),
               ("tpch_q1", "lineitem", TPCH_Q1_COLS, TPCH_Q1, None)]
    captured = {}
    wrapped = k2.group_accumulate

    def capture(slot, cols, m):
        captured["last"] = (slot, list(cols), m)
        return wrapped(slot, cols, m)

    k2.group_accumulate = capture
    report, inputs = {}, {}
    try:
        for qname, table, cols, sql, takes_k2 in queries:
            pt = ctx._tables[table]
            t0 = time.perf_counter()
            for rg in range(pt.num_row_groups):
                for c in cols:
                    pt.ensure_cached(rg, c)
            t_transcode = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            captured.clear()

            def run_once():
                st = dict(fused_agg.STATS)
                l1 = k1.LAUNCHES["cmp_const_many"]
                l2 = k2.LAUNCHES["group_accumulate"]
                out = ctx.sql(sql).to_arrow()
                torch.cuda.synchronize()
                if fused_agg.STATS["fused_grouped"] != st["fused_grouped"] + 1:
                    raise AssertionError(f"{qname} left the grouped route")
                pallas = fused_agg.STATS["fused_pallas"] - st["fused_pallas"]
                launched = k2.LAUNCHES["group_accumulate"] - l2
                if takes_k2 is not None and (
                        (pallas == 1 and launched > 0) != takes_k2
                        or pallas not in (0, 1)):
                    raise AssertionError(f"{qname}: K2 route {pallas}, "
                                         f"{launched} launches; expected "
                                         f"{takes_k2}")
                return out, dict(
                    k1=k1.LAUNCHES["cmp_const_many"] - l1, k2=launched,
                    pallas=pallas,
                    retries=(fused_agg.STATS["fused_retries"]
                             - st["fused_retries"]))

            t0 = time.perf_counter()
            out, first = run_once()
            t_first = time.perf_counter() - t0
            warm, per_run = [], None
            for _ in range(3):
                t0 = time.perf_counter()
                out, per_run = run_once()
                warm.append(time.perf_counter() - t0)
                if per_run["retries"]:
                    raise AssertionError(f"{qname}: a warm run retried")
            if not oracle.same_table(out, expect[qname]):
                raise AssertionError(f"{qname}: port {out.to_pylist()[:3]} "
                                     f"!= pyarrow")
            if per_run["k1"] != K1_PER_RUN[qname]:
                raise AssertionError(f"{qname}: {per_run['k1']} K1 launches "
                                     f"per run, expected {K1_PER_RUN[qname]}")
            row = dict(
                rows=pt.num_rows, groups_out=out.num_rows,
                transcode_s=t_transcode, first_run_s=t_first,
                first_run_retries=first["retries"],
                warm_best_ms=min(warm) * 1e3, warm_ms=[w * 1e3 for w in warm],
                k1_launches_per_run=per_run["k1"],
                k2_launches_per_run=per_run["k2"],
                k2_route=bool(per_run["pallas"]),
                max_memory_allocated=torch.cuda.max_memory_allocated())
            if "last" in captured:
                slot, cols, m = captured["last"]
                inputs[qname] = captured["last"]
                row.update(k2_n=int(slot.shape[0]), k2_C=len(cols),
                           k2_m=int(m))
            report[qname] = row
            log(f"[grouped] {qname}: {json.dumps(row)}")
    finally:
        k2.group_accumulate = wrapped
    return report, inputs


def star_reduction(p, mode: str, tiers: dict) -> dict:
    """A star plan's shape: probes, the reduction's physical keys and
    slot count m, and the tiers a warm run took (the change in
    `hashagg.TIERS`, counted where the reduction picks its tier)."""
    from liquid_tpu_torch.sql import fused_agg
    out = dict(mode=mode, probes=len(p.probes), fd=bool(p.fd),
               phys_keys=[str(k) for k in fused_agg._red_keys(p)],
               tiers=tiers)
    if mode == "grouped":
        doms = fused_agg._phys_domains(p)
        m = 1
        for _, span in doms or ():
            m *= span + 2
        out.update(m=m if doms else None,
                   packed_rows=1 + 2 * len(p.keys) + 2 * len(p.rslots),
                   reduced_keys=len(fused_agg._red_keys(p)))
    return out


def dimension_tables(ctx) -> list:
    """Every built dimension in the session's probe caches: table, key
    domain, index entries and bytes, scanned rows."""
    out = []
    for name, table in ctx._tables.items():
        for probe in getattr(table, "_star_probe_cache", {}).values():
            out.append(dict(table=name, key=probe.cache_key[1],
                            lo=probe.lo, hi=probe.hi,
                            idx_entries=int(probe.idx.numel()),
                            rows_scanned=probe.nrows, nbytes=probe.nbytes,
                            payloads=sorted(probe.payload)))
    return out


def keep_k1_inputs(inputs: list, seen: set, label: str, runs) -> None:
    """Append each (planes, lo, hi) of `runs` ((run name, calls) pairs)
    not in `seen` to `inputs` as (planes, lo, hi, label): the tensors a
    query run fed K1, kept alive (so their addresses stay unique) for
    phase 7 to check and time."""
    for run, calls in runs:
        for i, (planes, lo, hi) in enumerate(calls):
            key = (planes.data_ptr(), tuple(planes.shape), lo.data_ptr(),
                   hi.data_ptr())
            if key not in seen:
                seen.add(key)
                inputs.append((planes, lo, hi, f"{label} {run} run #{i}"))


def run_star_path(torch, ctx, expect: dict):
    """Phase 6b: TPC-H q3, q5 and q10 on the star path -> (per-query
    report, [(planes, lo, hi, label)] of every interval the star runs
    fed K1, dimension builds included, captured by wrapping the
    wrapper from here)."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import hashagg
    from liquid_tpu_torch.sql import fused_agg
    calls = []
    wrapped = k1.in_interval_many

    def capture(planes, lo, hi):
        calls.append((planes, lo, hi))
        return wrapped(planes, lo, hi)

    k1.in_interval_many = capture
    report, inputs, seen = {}, [], set()
    try:
        for qname, sql, tcols in STAR_QUERIES:
            t0 = time.perf_counter()
            for table, cols in tcols.items():
                pt = ctx._tables[table]
                for rg in range(pt.num_row_groups):
                    for c in cols:
                        pt.ensure_cached(rg, c)
            t_transcode = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            plans = ctx._exec.__dict__.setdefault("_star_plan_cache", {})
            cached = set(plans)

            def run_once():
                st, tiers = dict(fused_agg.STATS), dict(hashagg.TIERS)
                launches = k1.LAUNCHES["cmp_const_many"]
                calls.clear()
                out = ctx.sql(sql).to_arrow()
                torch.cuda.synchronize()
                if fused_agg.STATS["star_queries"] != st["star_queries"] + 1:
                    raise AssertionError(f"{qname} left the star route")
                # the wrapper launches for every call with planes to read
                run_calls = [c for c in calls if c[0].shape[0] * c[0].shape[1]]
                k1_run = k1.LAUNCHES["cmp_const_many"] - launches
                if k1_run != len(run_calls):
                    raise AssertionError(f"{qname}: {k1_run} K1 launches for "
                                         f"{len(run_calls)} interval calls")
                return out, k1_run, run_calls, {
                    k: v - tiers[k] for k, v in hashagg.TIERS.items()
                    if v != tiers[k]}

            t0 = time.perf_counter()
            out, first_k1, first_calls, _ = run_once()
            t_first = time.perf_counter() - t0
            warm, outs = [], {"first": out}
            for _ in range(3):
                t0 = time.perf_counter()
                out, per_run, warm_calls, tiers = run_once()
                warm.append(time.perf_counter() - t0)
            outs["last warm"] = out
            for what, got in outs.items():
                if not oracle.same_table(got, expect[qname]):
                    raise AssertionError(f"{qname} ({what} run): port "
                                         f"{got.to_pylist()[:2]} != pyarrow")
            for want, got, what in ((K1_PER_RUN, per_run, "warm"),
                                    (K1_FIRST_RUN, first_k1, "first")):
                if got != want[qname]:
                    raise AssertionError(f"{qname}: {got} K1 launches in the "
                                         f"{what} run, expected {want[qname]}")
            keep_k1_inputs(inputs, seen, f"star {qname}",
                           (("first", first_calls), ("warm", warm_calls)))
            report[qname] = dict(
                rows={t: ctx._tables[t].num_rows for t in tcols},
                groups_out=out.num_rows, transcode_s=t_transcode,
                first_run_s=t_first, first_run_k1=first_k1,
                warm_best_ms=min(warm) * 1e3,
                warm_ms=[w * 1e3 for w in warm], k1_launches_per_run=per_run,
                reduction=star_reduction(*next(
                    h for k, h in plans.items() if k not in cached)[:2],
                    tiers),
                max_memory_allocated=torch.cuda.max_memory_allocated())
            log(f"[star] {qname}: {json.dumps(report[qname])}")
    finally:
        k1.in_interval_many = wrapped
    log(f"[star] dimensions: {json.dumps(dimension_tables(ctx))}")
    return report, inputs


def run_slice_path(torch, ctx, expect: dict):
    """Phase 6c: count(DISTINCT), the temporal keys and the fused bare
    SELECT on the hits session -> per-query report.  Each answer is
    checked against pyarrow (`bench/oracle.py`, the tie rule for a LIMIT
    that cuts through ties), the route counter named in `SLICE_QUERIES`
    moves by one per run and the fused route (`fused_queries`) with it,
    and K1 launches per warm run equal `K1_PER_RUN`."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.sql import fused_agg
    pt = ctx._tables["hits"]
    report = {}
    for qname, query, route, cols in SLICE_QUERIES:
        sql = slice_sql(query)
        t0 = time.perf_counter()
        for rg in range(pt.num_row_groups):
            for c in cols:
                pt.ensure_cached(rg, c)
        t_transcode = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()

        def run_once():
            st = dict(fused_agg.STATS)
            launches = k1.LAUNCHES["cmp_const_many"]
            out = ctx.sql(sql).to_arrow()
            torch.cuda.synchronize()
            moved = {r: fused_agg.STATS[r] - st[r] for r in SLICE_ROUTES}
            want = {r: int(r == route or (r == "fused_grouped" and route in (
                "distinct_sort", "distinct_chained", "distinct_fold")))
                for r in SLICE_ROUTES}
            if moved != want or fused_agg.STATS["fused_queries"] \
                    == st["fused_queries"]:
                raise AssertionError(f"{qname}: routes {moved}, expected "
                                     f"{want} and the fused route")
            return out, k1.LAUNCHES["cmp_const_many"] - launches

        t0 = time.perf_counter()
        out, first_k1 = run_once()
        t_first = time.perf_counter() - t0
        warm, outs = [], {"first": out}
        for _ in range(3):
            t0 = time.perf_counter()
            out, per_run = run_once()
            warm.append(time.perf_counter() - t0)
        outs["last warm"] = out
        for what, got in outs.items():
            if not oracle.same_table(got, expect[qname],
                                     oracle.CUTS.get(qname)):
                raise AssertionError(f"{qname} ({what} run): port "
                                     f"{got.to_pylist()[:2]} != pyarrow")
        if per_run != K1_PER_RUN[qname]:
            raise AssertionError(f"{qname}: {per_run} K1 launches per warm "
                                 f"run, expected {K1_PER_RUN[qname]}")
        report[qname] = dict(
            rows=pt.num_rows, answer_rows=out.num_rows, route=route,
            transcode_s=t_transcode, first_run_s=t_first,
            first_run_k1=first_k1, warm_best_ms=min(warm) * 1e3,
            warm_ms=[w * 1e3 for w in warm], k1_launches_per_run=per_run,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        log(f"[slice] {qname}: {json.dumps(report[qname])}")
    return report


def run_multi_path(torch, ctx, expect: dict):
    """Phase 6d: TPC-H q4, q7, q8, q9, q11, q16, q18, q21 and q22 on the
    session -> (per-query report, [(planes, lo, hi, label)] of every
    interval the first and the last warm runs fed K1, dimension and
    existence builds included, {query: (slot, cols, m)} as a run last
    fed K2).  Each answer (first run and last warm run) is checked
    against pyarrow (`bench/oracle.py`, the tie rule where a LIMIT
    cuts), the route counters move as `MULTI_QUERIES` says on every run,
    and K1 launches equal `K1_PER_RUN` per warm run and `K1_FIRST_RUN`
    in the first; every launch is one call of the wrapper with planes
    to read, counted and captured by wrapping the wrappers from here.
    K2 launches and the reduction tiers (`hashagg.TIERS`) of a warm run
    are reported."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    from liquid_tpu_torch.ops import hashagg
    from liquid_tpu_torch.sql import fused_agg
    calls, captured = [], {}
    wrapped, wrapped2 = k1.in_interval_many, k2.group_accumulate

    def capture(planes, lo, hi):
        if planes.shape[0] * planes.shape[1]:
            calls.append((planes, lo, hi))
        return wrapped(planes, lo, hi)

    def capture2(slot, cols, m):
        captured["last"] = (slot, list(cols), m)
        return wrapped2(slot, cols, m)

    k1.in_interval_many, k2.group_accumulate = capture, capture2
    report, k1_inputs, k2_inputs, seen = {}, [], {}, set()
    try:
        for qname, qid, routes, tcols in MULTI_QUERIES:
            sql = multi_sql(qid)
            t0 = time.perf_counter()
            for table, cols in tcols.items():
                pt = ctx._tables[table]
                for rg in range(pt.num_row_groups):
                    for c in cols:
                        pt.ensure_cached(rg, c)
            t_transcode = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            captured.clear()

            def run_once():
                st, tiers = dict(fused_agg.STATS), dict(hashagg.TIERS)
                launches = k1.LAUNCHES["cmp_const_many"]
                k2_launches = k2.LAUNCHES["group_accumulate"]
                calls.clear()
                out = ctx.sql(sql).to_arrow()
                torch.cuda.synchronize()
                moved = {r: fused_agg.STATS[r] - st[r] for r in routes}
                if moved != routes:
                    raise AssertionError(f"{qname}: routes {moved}, "
                                         f"expected {routes}")
                k1_run = k1.LAUNCHES["cmp_const_many"] - launches
                if k1_run != len(calls):
                    raise AssertionError(f"{qname}: {k1_run} K1 launches "
                                         f"for {len(calls)} interval calls")
                return out, k1_run, list(calls), {
                    "k2": k2.LAUNCHES["group_accumulate"] - k2_launches,
                    "tiers": {k: v - tiers[k] for k, v in
                              hashagg.TIERS.items() if v != tiers[k]}}

            t0 = time.perf_counter()
            out, first_k1, first_calls, _ = run_once()
            t_first = time.perf_counter() - t0
            outs, warm = {"first": out}, []
            for _ in range(3):
                t0 = time.perf_counter()
                out, per_run, warm_calls, reduction = run_once()
                warm.append(time.perf_counter() - t0)
            outs["last warm"] = out
            keep_k1_inputs(k1_inputs, seen, f"multi {qname}",
                           (("first", first_calls), ("warm", warm_calls)))
            for what, got in outs.items():
                if not oracle.same_table(got, expect[qname],
                                         oracle.CUTS.get(qname)):
                    raise AssertionError(f"{qname} ({what} run): port "
                                         f"{got.to_pylist()[:2]} != pyarrow")
            for want, got, what in ((K1_PER_RUN, per_run, "warm"),
                                    (K1_FIRST_RUN, first_k1, "first")):
                if got != want[qname]:
                    raise AssertionError(f"{qname}: {got} K1 launches in the "
                                         f"{what} run, expected {want[qname]}")
            report[qname] = dict(
                rows={t: ctx._tables[t].num_rows for t in tcols},
                answer_rows=out.num_rows, routes=routes,
                transcode_s=t_transcode, first_run_s=t_first,
                first_run_k1=first_k1, warm_best_ms=min(warm) * 1e3,
                warm_ms=[w * 1e3 for w in warm], k1_launches_per_run=per_run,
                k2_launches_per_run=reduction["k2"],
                tiers_per_run=reduction["tiers"],
                max_memory_allocated=torch.cuda.max_memory_allocated())
            if "last" in captured:
                slot, cols, m = k2_inputs[qname] = captured["last"]
                report[qname].update(k2_n=int(slot.shape[0]), k2_C=len(cols),
                                     k2_m=int(m))
            log(f"[multi] {qname}: {json.dumps(report[qname])}")
    finally:
        k1.in_interval_many, k2.group_accumulate = wrapped, wrapped2
    return report, k1_inputs, k2_inputs


def run_classic_path(torch, ctx, expect: dict):
    """Phase 6e: the classic path on the session -> (per-query report,
    [(planes, cs, label)] of every K1 single-form input the runs gave).
    Each answer (first run and last warm run) is checked against pyarrow
    (`bench/oracle.py`, the tie rule where a LIMIT cuts), the classic
    counter named in `classic_queries` moves on every run, and K1's
    single-form launches in every run equal `classic_k1_per_run`; every
    single-form launch is one call of the
    wrapper, counted and captured by wrapping it from here.  The device
    time of the joins' sorts and probes (`ops/join.py`) is read from CUDA
    events around each call."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import join as jops
    from liquid_tpu_torch.sql import exec as sql_exec
    calls, events = [], []
    wrapped = k1.cmp_const_many
    join_ops = {n: getattr(jops, n) for n in ("sort_build", "probe_bounds",
                                               "expand_matches",
                                               "matched_flags")}

    def capture(planes, cs):
        if planes.shape[0] * planes.shape[1]:
            calls.append((planes, cs))
        return wrapped(planes, cs)

    def timed(fn):
        def run(*a):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            out = fn(*a)
            e.record()
            events.append((s, e))
            return out
        return run

    k1.cmp_const_many = capture
    for name, fn in join_ops.items():
        setattr(jops, name, timed(fn))
    report, inputs, seen = {}, [], set()
    k1_want = classic_k1_per_run(ctx)
    try:
        for qname, sql, counter in classic_queries():
            torch.cuda.reset_peak_memory_stats()

            def run_once():
                st = dict(sql_exec.STATS)
                launches = k1.LAUNCHES["cmp_const_many"]
                calls.clear()
                events.clear()
                out = run_statements(ctx, sql)
                torch.cuda.synchronize()
                if sql_exec.STATS[counter] <= st[counter]:
                    raise AssertionError(f"{qname} left the classic route: "
                                         f"{sql_exec.STATS} vs {st}")
                join_ms = sum(s.elapsed_time(e) for s, e in events)
                return (out, k1.LAUNCHES["cmp_const_many"] - launches,
                        list(calls), join_ms, len(events))

            t0 = time.perf_counter()
            out, first_k1, first_calls, first_join_ms, _ = run_once()
            t_first = time.perf_counter() - t0
            outs, warm, singles = {"first": out}, [], [len(first_calls)]
            for _ in range(3):
                t0 = time.perf_counter()
                out, per_run, warm_calls, join_ms, join_calls = run_once()
                warm.append(time.perf_counter() - t0)
                singles.append(len(warm_calls))
            outs["last warm"] = out
            for what, got in outs.items():
                if not oracle.same_table(got, expect[qname],
                                         oracle.CUTS.get(qname)):
                    raise AssertionError(f"{qname} ({what} run): port "
                                         f"{got.to_pylist()[:2]} != pyarrow")
            if set(singles) != {k1_want[qname]}:
                raise AssertionError(f"{qname}: K1 single-form launches per "
                                     f"run {singles}, expected "
                                     f"{k1_want[qname]} in each")
            for run, got in (("first", first_calls), ("warm", warm_calls)):
                for i, (planes, cs) in enumerate(got):
                    key = (planes.data_ptr(), tuple(planes.shape),
                           cs.data_ptr())
                    if key not in seen:
                        seen.add(key)
                        inputs.append((planes, cs,
                                       f"classic {qname} {run} run #{i}"))
            report[qname] = dict(
                answer_rows=out.num_rows, route=counter,
                first_run_s=t_first, first_run_k1=first_k1,
                warm_best_ms=min(warm) * 1e3,
                warm_ms=[w * 1e3 for w in warm], k1_launches_per_run=per_run,
                k1_single_form_per_run=singles[-1],
                join_device_ms=join_ms, join_ops=join_calls,
                first_run_join_device_ms=first_join_ms,
                max_memory_allocated=torch.cuda.max_memory_allocated())
            log(f"[classic] {qname}: {json.dumps(report[qname])}")
    finally:
        k1.cmp_const_many = wrapped
        for name, fn in join_ops.items():
            setattr(jops, name, fn)
    return report, inputs


def k1_single_bytes(bsz: int, width: int) -> int:
    """Bytes K1's single form must move: planes and the constants read
    once, both masks written."""
    return bsz * width * 256 * 4 + bsz * 8 + 2 * bsz * 256 * 4


def time_k1_single(torch, inputs: list) -> dict:
    """Phase 7, the single form: every (planes, cs) phase 6e gave K1
    checked bit-exact against `cmp_const_many_ref`, and the largest timed
    (timer B, L2 flushed) beside its plain version and its byte bound."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    if not inputs:
        raise AssertionError("phase 6e left no K1 single-form inputs")
    worst = 0
    for planes, cs, _label in inputs:
        worst = max(worst, _max_abs_err(torch, k1.cmp_const_many(planes, cs),
                                        k1.cmp_const_many_ref(planes, cs)))
    if worst:
        raise AssertionError(f"K1's single form != plain on phase 6e's "
                             f"inputs: {worst}")
    planes, cs, label = max(inputs, key=lambda x: x[0].numel())
    bsz, width, _ = planes.shape
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    t_bytes = k1_single_bytes(bsz, width) / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * width * bsz * 256 / WORD_OPS_PER_S * 1e3
    row = dict(inputs=len(inputs), column=label, B=bsz, w=width,
               bytes=k1_single_bytes(bsz, width),
               ms=time_cold(torch, lambda: k1.cmp_const_many(planes, cs),
                            flush, 100),
               plain_ms=time_cold(torch, lambda: k1.cmp_const_many_ref(
                   planes, cs), flush, 20),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=worst)
    log(f"[k1-single] {json.dumps(row)}")
    return row


def main_path_k1_inputs(ctx):
    """(planes, lo, hi, query table) for every interval the main path's
    cached plans fed to K1."""
    out = []
    for name, table in ctx._tables.items():
        for hit in getattr(table, "_fused_plan_cache", {}).values():
            if isinstance(hit, str) or hit[2]:  # a bailout, an empty scan
                continue
            p = hit[0]
            for grp in p.pred_groups:
                for alt in grp:
                    if alt[0] == "lut":  # a string column: no planes
                        continue
                    out.append((p.arrays[p.colmap[alt[1]]["planes"]],
                                p.arrays[alt[2]], p.arrays[alt[3]],
                                f"{name}.{alt[1]}"))
    return out


def time_k1(torch, ctx, star_inputs: list) -> dict:
    """Phase 7: K1's interval form on the main path's own (planes, lo,
    hi) -- the single-table plans' and `star_inputs`, those the star and
    multi-table phases captured -- checked bit-exact and timed beside the two
    single-constant launches it replaces (a pair after one L2 flush, as
    the old path ran them, and one alone), its plain version and its
    byte bound."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    rows, worst = [], 0
    for planes, lo, hi, col in main_path_k1_inputs(ctx) + star_inputs:
        worst = max(worst, _max_abs_err(
            torch, [k1.in_interval_many(planes, lo, hi)],
            [k1.in_interval_many_ref(planes, lo, hi)]))
        for cs in (lo, hi):
            worst = max(worst, _max_abs_err(
                torch, k1.cmp_const_many(planes, cs),
                k1.cmp_const_many_ref(planes, cs)))
        bsz, width, _ = planes.shape
        bound, by = k1_bound_ms(bsz, width)

        def interval():
            return k1.in_interval_many(planes, lo, hi)

        def pair():
            k1.cmp_const_many(planes, lo)
            k1.cmp_const_many(planes, hi)

        row = dict(column=col, B=bsz, w=width, bytes=k1_bytes(bsz, width),
                   ms=time_cold(torch, interval, flush, 100),
                   two_single_ms=time_cold(torch, pair, flush, 100),
                   single_ms=time_cold(
                       torch, lambda: k1.cmp_const_many(planes, lo), flush,
                       100),
                   warm_ms=time_warm(torch, interval, 200),
                   two_single_warm_ms=time_warm(torch, pair, 200),
                   plain_ms=time_cold(
                       torch, lambda: k1.in_interval_many_ref(planes, lo, hi),
                       flush, 20),
                   bound_ms=bound, bound_by=by)
        row.update(over_two_single=row["ms"] / row["two_single_ms"],
                   over_twice_single=row["ms"] / (2 * row["single_ms"]))
        rows.append(row)
        log(f"[k1] {json.dumps(row)}")
    if not rows:
        raise AssertionError("the main path left no K1 inputs to time")
    if worst:
        raise AssertionError(f"K1 != plain on main-path inputs: {worst}")
    return {"rows": rows, "max_abs_err": worst}


def time_k2(torch, inputs: dict) -> dict:
    """Phase 8: K2 vs its plain version and one index_add_ call, on the
    slot and columns the grouped and multi-table phases fed it, with
    the bytes its flush adds into the output."""
    from liquid_tpu_torch.ops import grouphist as gh
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    rows, worst = {}, 0
    for qname, (slot, cols, m) in inputs.items():
        worst = max(worst, int((k2.group_accumulate(slot, cols, m)
                                - gh.group_accumulate_ref(slot, cols, m)
                                ).abs().max()))
        n, ncols = int(slot.shape[0]), len(cols)
        bound, by = k2_bound_ms(n, ncols, m)
        flush_bytes, flush_most = k2_flush_bytes(torch, slot, cols, m)
        # the library call: index_add_ on int64 copies of the same inputs
        # (the main path's slots lie in [0, m] already)
        s64 = slot.to(torch.int64)
        v64 = torch.stack(cols, dim=1).to(torch.int64)
        table = torch.zeros((m + 1, ncols), dtype=torch.int64, device="cuda")
        row = dict(n=n, C=ncols, m=int(m), bytes=k2_bytes(n, ncols, m),
                   flush_bytes=flush_bytes, flush_bytes_most=flush_most,
                   ms=time_cold(torch, lambda: k2.group_accumulate(
                       slot, cols, m), flush, 50),
                   warm_ms=time_warm(torch, lambda: k2.group_accumulate(
                       slot, cols, m), 100),
                   plain_ms=time_cold(torch, lambda: gh.group_accumulate_ref(
                       slot, cols, m), flush, 20),
                   library_ms=time_cold(torch, lambda: table.index_add_(
                       0, s64, v64), flush, 20),
                   bound_ms=bound, bound_by=by)
        row["library_over_kernel"] = row["library_ms"] / row["ms"]
        rows[qname] = row
        log(f"[k2] {qname}: {json.dumps(row)}")
    if not rows:
        raise AssertionError("the main path left no K2 inputs to time")
    if worst:
        raise AssertionError(f"K2 != plain on main-path inputs: {worst}")
    return {"rows": rows, "max_abs_err": worst}


def device_breakdown(torch, ctx, sql: str, warm_best_ms: float) -> dict:
    """Phase 9: one warm run of `sql` under torch.profiler -> device-busy
    ms (union of kernel and copy intervals), the idle share of the
    unprofiled best warm time, the device operation count and the
    device operations that took longest.  The profiler slows the host,
    so its own wall time is reported but not used for the idle share.
    One unprofiled run first: a cache insert since the query's own warm
    runs (a later phase transcoding its columns) makes its next run plan
    and upload again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_statements(ctx, sql)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_statements(ctx, sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    cats = sorted(((n, v) for n, v in by_name.items() if "Cat" in n),
                  key=lambda kv: -kv[1][0])
    return dict(
        ms_by_name={n: us / 1e3 for n, (us, _c) in by_name.items()},
        profiled_wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
        idle_share=(1 - busy_us / 1e3 / warm_best_ms) if dev else None,
        device_ops=len(dev),
        top=[dict(name=n[:90], ms=us / 1e3, count=c)
             for n, (us, c) in top],
        cat=[dict(name=n[:90], ms=us / 1e3, count=c)
             for n, (us, c) in cats])


#: the fused select's host steps: (step, file, function cProfile names)
SELECT_STEPS = (("total", "fused_agg.py", "try_fused_select"),
                ("mini_planner", "fused_star.py", "prep_of"),
                ("null_check", "fused_star.py", "_prep_has_nulls"),
                ("device_run", "fused_agg.py", "_fused_select_run"),
                ("fetch", "~", "<method 'cpu' of 'torch._C.TensorBase' "
                 "objects>"),
                ("cell_reads", "fused_agg.py", "block"))


def host_split(ctx, sql: str) -> dict:
    """Phase 9: one warm run of a bare SELECT under cProfile -> ms of each
    of the fused select's host steps (cumulative, so `total` holds the
    others; `other` is what no step names)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    ctx.sql(sql).to_arrow()
    prof.disable()
    stats = pstats.Stats(prof).stats
    out = {step: 1e3 * sum(v[3] for (f, _l, fn), v in stats.items()
                           if fn == name and f.endswith(where))
           for step, where, name in SELECT_STEPS}
    out["other"] = out["total"] - sum(
        v for k, v in out.items() if k != "total")
    return out


#: (part of the profile's kernel names, what they are)
SCATTER_KERNELS = (("indexFunc", "index_add_ms"),
                   ("_scatter_gather_elementwise_kernel", "scatter_reduce_ms"))


def trash_band(torch, args) -> int:
    """`--trash-band LABEL [--tree DIR]`: the device time of the grouped
    scatters, for comparing two trees of the port on one card (the dead
    rows' trash band against a single trash row).  `liquid_tpu_torch` is
    imported from `--tree` (default: this script's directory).  On the
    data of `--data-dir` it runs `tpch_q3`, `tpch_q10`, `tpch_q15_revenue`
    and `cb_q15`: one first run, three warm runs (best kept), then phase
    9's profiled warm run, which gives device busy and the device time of
    the `index_add_` kernels (`indexFunc*`) and of the `scatter_reduce_`
    kernels (`_scatter_gather_elementwise_kernel`).  Prints one JSON
    line."""
    import liquid_tpu_torch
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench.main import prepare_data
    tree = os.path.dirname(os.path.dirname(liquid_tpu_torch.__file__))
    paths = prepare_data(args.data_dir, args.hits_rows, args.sf)
    ctx, _cache = LiquidCacheLocalBuilder().with_max_memory_bytes(
        16 << 30).build()
    for name, p in paths.items():
        ctx.register_parquet(name, p)
    rows = {}
    for qname, sql in (("tpch_q3", TPCH_Q3), ("tpch_q10", TPCH_Q10),
                       ("tpch_q15_revenue", TPCH_Q15_REVENUE),
                       ("cb_q15", CB_Q15)):
        t0 = time.perf_counter()
        ctx.sql(sql).to_arrow()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            ctx.sql(sql).to_arrow()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        bd = device_breakdown(torch, ctx, sql, min(warm))
        row = dict(first_run_s=first, warm_best_ms=min(warm), warm_ms=warm,
                   device_busy_ms=bd["device_busy_ms"],
                   idle_share=bd["idle_share"], device_ops=bd["device_ops"],
                   top=bd["top"][:4])
        for needle, what in SCATTER_KERNELS:
            row[what] = sum(ms for n, ms in bd["ms_by_name"].items()
                            if needle in n)
        rows[qname] = row
        log(f"[trash_band] {args.trash_band} {qname}: {json.dumps(row)}")
    print(json.dumps({"label": args.trash_band, "tree": tree,
                      "card": card_line(), "queries": rows}), flush=True)
    return 0


def _reset(counters) -> None:
    for c in counters:
        for key in c:
            c[key] = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hits-rows", type=int, default=4_000_000)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "liquid_tpu_torch_smoke"))
    ap.add_argument("--trash-band", metavar="LABEL",
                    help="only time the grouped scatters (see trash_band)")
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose liquid_tpu_torch --trash-band times")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.trash_band:
        sys.path.insert(0, os.path.abspath(args.tree))
        return trash_band(torch, args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor
    from liquid_tpu_torch import _native
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.bench.main import TPCH_TABLES, prepare_data
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    from liquid_tpu_torch.ops import nvcc

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    import numpy
    import pyarrow
    log(f"[device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda} numpy {numpy.__version__} pyarrow "
        f"{pyarrow.__version__}; nvidia-smi: {card}")

    # 2. build the three kernel sources (one nvcc each) and the native
    #    FSST library (g++), all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native.build)
        libs = nvcc.build_many([k1.SOURCE, k2.SOURCE, k1.PLANES_SOURCE],
                               verbose=True)
        native_lib = native.result()
    log(f"[build] {sorted(os.path.relpath(v) for v in libs.values())} + "
        f"{os.path.relpath(native_lib)} in {time.perf_counter() - t0:.2f} s")
    log(f"[sass] K2 shared atomics {k2_sass_atomics(libs[k2.SOURCE])}")

    # 3. K1 vs plain, every width and batch shape
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    err1 = check_k1(torch, dev)
    log(f"[k1-check] bit-exact over widths 1..64 x B {{1,3,489,4097}}, "
        f"single and interval forms ({time.perf_counter() - t0:.1f} s)")

    # 4. K2 vs plain, every slot count, width and skew
    t0 = time.perf_counter()
    err2 = check_k2(torch, dev)
    log(f"[k2-check] bit-exact over m {{1,63,8889,16385,65535}} x C "
        f"{{1,4,7,16}} x n {{2048,4097,4005888,4005891}} x uniform/zipf "
        f"slots ({time.perf_counter() - t0:.1f} s)")

    # 4b. K3 and K4 vs plain, every width, three word counts, both forms
    t0 = time.perf_counter()
    err34 = check_k34(torch, dev)
    log(f"[k34-check] bit-exact over widths 0..64 x W {{256,4096,2^22}} x "
        f"constants {{0,1,random,2^w-1,>=2^w,2^64-1}}, flat and prepped "
        f"({time.perf_counter() - t0:.1f} s)")

    # 5. scalar main path, counts reset just before and read just after
    t0 = time.perf_counter()
    # `part` for q14 and `partsupp` for phase 6d beside the bench entry
    # point's tables
    paths = prepare_data(args.data_dir, args.hits_rows, args.sf,
                         TPCH_TABLES + ("part", "partsupp"))
    expect = oracle.answers(paths, list(oracle.ORACLES))
    log(f"[data] {paths} ({time.perf_counter() - t0:.1f} s)")
    counters = (k1.LAUNCHES, k2.LAUNCHES)
    _reset(counters)
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    ctx, report = run_main_path(torch, paths, expect,
                                LiquidCacheLocalBuilder())
    scalar_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if ctx.device.type != "cuda":
        raise AssertionError(f"the session ran on {ctx.device}")
    # one K1 launch per interval predicate and warm run is asserted in
    # run_main_path (cb_like's only predicate is a verdict LUT: none)
    if scalar_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"the scalar path did not launch K1: "
                             f"{scalar_launches}")

    # 6. grouped main path, counts reset just before and read just after
    _reset(counters)
    greport, k2_inputs = run_grouped_path(torch, ctx, paths, expect)
    grouped_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if grouped_launches["group_accumulate"] <= 0:
        raise AssertionError(f"the grouped path did not launch K2: "
                             f"{grouped_launches}")
    # 6b. the star path, counts reset just before and read just after
    _reset(counters)
    sreport, star_k1_inputs = run_star_path(torch, ctx, expect)
    star_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if star_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"the star path did not launch K1: "
                             f"{star_launches}")
    # 6c. the single-table slice, counts reset just before and read after
    _reset(counters)
    log(f"[slice] the data's distinct UserID values: "
        f"{expect['cb_q4'][0][0].as_py()}")
    slice_report = run_slice_path(torch, ctx, expect)
    slice_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if slice_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"the slice did not launch K1: {slice_launches}")
    # 6d. TPC-H's multi-table queries, counts reset just before and read
    #     just after
    _reset(counters)
    multi_report, multi_k1_inputs, multi_k2_inputs = run_multi_path(
        torch, ctx, expect)
    multi_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if multi_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"phase 6d did not launch K1: {multi_launches}")
    # 6e. the classic path, counts reset just before and read just after
    from liquid_tpu_torch.sql import device_agg, device_join
    _reset(counters)
    join0, agg0 = dict(device_join.STATS), dict(device_agg.STATS)
    classic_report, classic_k1_inputs = run_classic_path(torch, ctx, expect)
    classic_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    joins = {k: v - join0[k] for k, v in device_join.STATS.items()}
    aggs = {k: v - agg0[k] for k, v in device_agg.STATS.items()}
    log(f"[classic] joins {json.dumps(joins)}; aggregators "
        f"{json.dumps(aggs)}; K1 single-form inputs "
        f"{len(classic_k1_inputs)}")
    if joins["device_joins"] <= 0 or aggs["device_grouped_updates"] <= 0 \
            or not classic_k1_inputs:
        raise AssertionError(f"phase 6e: no sort-merge join on the card, "
                             f"no grouped device aggregation or no K1 "
                             f"single-form launch: {joins} {aggs}")
    log(f"[launches] scalar path {json.dumps(scalar_launches)}; grouped "
        f"path {json.dumps(grouped_launches)}; star path "
        f"{json.dumps(star_launches)}; slice {json.dumps(slice_launches)}; "
        f"multi-table {json.dumps(multi_launches)}; classic "
        f"{json.dumps(classic_launches)}")

    # 7. K1's interval form checked and timed on the main path's own
    #    inputs, the star and multi-table phases' included
    timing = time_k1(torch, ctx, star_k1_inputs + multi_k1_inputs)
    top = max(timing["rows"], key=lambda r: r["bytes"])
    log(f"[k1] largest input {top['column']}: interval / two single "
        f"launches {top['over_two_single']:.3f}, / twice one single "
        f"{top['over_twice_single']:.3f}")
    single = time_k1_single(torch, classic_k1_inputs)

    # 8. K2 checked and timed on the grouped and multi-table phases' own
    #    inputs
    k2_timing = time_k2(torch, {**k2_inputs, **multi_k2_inputs})
    k2_top = k2_timing["rows"]["cb_groupby"]

    # 9. where a warm query's device time goes
    warm = {q: r["warm_best_ms"] for q, r in
            {**report, **greport, **sreport, **slice_report,
             **multi_report, **classic_report}.items()}
    for qname, sql in (("cb_filter", CB_FILTER), ("cb_like", CB_LIKE),
                       ("tpch_q6", TPCH_Q6), ("cb_groupby", CB_GROUPBY),
                       ("cb_q15", CB_Q15),
                       ("tpch_q15_revenue", TPCH_Q15_REVENUE),
                       ("tpch_supp_price", TPCH_SUPP_PRICE),
                       ("tpch_q1", TPCH_Q1)) + tuple(
                           (q, sql) for q, sql, _ in STAR_QUERIES) + tuple(
                           (q, slice_sql(query))
                           for q, query, _r, _c in SLICE_QUERIES) + tuple(
                           (q, multi_sql(qid))
                           for q, qid, _r, _c in MULTI_QUERIES) + tuple(
                           (q, sql) for q, sql, _r in classic_queries()):
        bd = device_breakdown(torch, ctx, sql, warm[qname])
        del bd["ms_by_name"]
        log(f"[profile] {qname}: {json.dumps(bd)}")
        if qname in ("cb_q24", "cb_q26"):
            log(f"[host] {qname}: {json.dumps(host_split(ctx, sql))}")
    del ctx

    # 9b. the benchmark entry point in this process, counts reset just
    #     before and read just after (K3 runs in its micro line)
    _reset(counters)
    t0 = time.perf_counter()
    _harness, op_launches = run_harness(torch, args)
    # the operator lines time K1 and K2 in loops: their launches are
    # measurement, reported apart from the queries' and the micro line's
    harness_launches = {k: v - op_launches.get(k, 0) for k, v in
                        {**k1.LAUNCHES, **k2.LAUNCHES}.items()}
    log(f"[harness] {time.perf_counter() - t0:.1f} s; launches by the "
        f"queries and the micro line {json.dumps(harness_launches)}, by "
        f"the operator timing loops {json.dumps(op_launches)}")
    if harness_launches["cmp_const_many"] <= 0 \
            or harness_launches["count_gt"] < 256:
        raise AssertionError(f"the harness did not launch K1 and K3: "
                             f"{harness_launches}")

    # 10. K3 and K4 timed on the micro line's input
    k34 = time_k34(torch)
    phases = {"scalar": scalar_launches, "grouped": grouped_launches,
              "star": star_launches, "slice": slice_launches,
              "multi": multi_launches, "classic": classic_launches,
              "harness": harness_launches,
              "harness_operator_timing": op_launches}

    def launches(name):
        # the main path's launches: the query phases and the micro line
        return sum(phases[p][name]
                   for p in ("scalar", "grouped", "star", "slice", "multi",
                             "classic", "harness"))

    def by_phase(name):
        return {p: d.get(name, 0) for p, d in phases.items()}

    kernels = [{
        "name": "cmp_const_many", "route": "cuda",
        "source": "liquid_tpu_torch/ops/csrc/cmp_const_many.cu",
        "replaces": "liquid_tpu/ops/bitpack_pallas.py:212",
        "launches": launches("cmp_const_many"),
        "launches_by_phase": by_phase("cmp_const_many"),
        "max_abs_err": max(err1, timing["max_abs_err"],
                           single["max_abs_err"]), "tolerance": 0,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "form": "interval",
        "two_single_ms": top["two_single_ms"],
        "single_ms": top["single_ms"],
        "shape": [top["B"], top["w"], 256], "column": top["column"],
        "single_form": {k: single[k] for k in (
            "inputs", "column", "B", "w", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "matches_plain": True,
    }, {
        "name": "group_accumulate", "route": "cuda",
        "source": "liquid_tpu_torch/ops/csrc/group_accumulate.cu",
        "replaces": "liquid_tpu/ops/grouphist_pallas.py:156",
        "launches": launches("group_accumulate"),
        "launches_by_phase": by_phase("group_accumulate"),
        "max_abs_err": max(err2, k2_timing["max_abs_err"]), "tolerance": 0,
        "ms": k2_top["ms"], "plain_ms": k2_top["plain_ms"],
        "bound_ms": k2_top["bound_ms"], "bound_by": k2_top["bound_by"],
        "library_ms": k2_top["library_ms"],
        "flush_bytes": k2_top["flush_bytes"],
        "shape": {"n": k2_top["n"], "C": k2_top["C"], "m": k2_top["m"]},
        "query": "cb_groupby", "matches_plain": True,
    }]
    for name, line in (("count_gt", 153), ("cmp_const_planes", 77)):
        row = k34[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "liquid_tpu_torch/ops/csrc/cmp_planes.cu",
            "replaces": f"liquid_tpu/ops/bitpack_pallas.py:{line}",
            "launches": launches(name),
            "launches_by_phase": by_phase(name),
            "max_abs_err": max(err34, row["max_abs_err"]), "tolerance": 0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": [row["w"], row["rows"] // 32], "matches_plain": True,
        })
    summary = {**report, **greport, **sreport, **slice_report,
               **multi_report, **classic_report}
    log(f"[summary] {json.dumps(summary)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
