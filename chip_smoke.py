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
   K3 and K4 (`ops/csrc/cmp_planes.cu`), K4's fused form
   (`ops/csrc/select_planes.cu`); K2's shared-memory atomics read from
   its SASS (`cuobjdump -sass`), failing on a CAS loop;
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
   2^64-1, on flat and prepped planes; K4's fused form (`select_planes`,
   the mesh's shard selection) against `select_planes_ref`, bit-exact,
   over W in {1, 255, 46,863, 2^22} words and P in {1, 2, 5, 16, 17}
   predicates per call (17 lone columns: two chained launches), widths
   0..64 mixed within a call, every op, interval pairs, validity on and
   off, constants 0, 2^w-1, 2^w, 2^64-1 and one inside the width, its
   launches equal to `select_launches` (`check_select`);
5. the scalar main path: 4,000,000 synthesized ClickBench `hits` rows and
   TPC-H SF1 `lineitem` as parquet (every data file of the run, phases
   6g's, 6h's and 6k's included, written by `write_data` in five worker
   processes), a
   `LiquidCacheLocalBuilder` session on the card, queries `cb_filter`,
   `cb_like` (a string LIKE: verdicts over FSST dictionaries, gathered
   by code) and `tpch_q6`; answers
   checked against pyarrow on the same parquet (`bench/oracle.py`:
   integers exact, floats rtol 1e-9); the fused scalar route and one K1
   launch per interval predicate (`K1_PER_RUN`) checked through the
   port's counters, which are set to 0 just before this phase and read
   after; then, on the filled cache (`check_members`), `LiquidArray.
   filter` on the card over every cached block of hits' `AdvEngineID`
   (primitive) and `URL` (byte-view) under `cb_filter`'s selection and
   of lineitem's `l_discount` (float: hits has none) under `l_quantity <
   24`, each column's blocks together equal to pyarrow's `filter`, and
   `BoolMask.from_bools` on the card equal to its CPU result;
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
   `classic_k1_per_run` in every run (one per row group, pushdown
   predicate and width bucket the scan hands the cache, a bucket of one
   block included: `k1_groups`); in the phase, at least
   one sort-merge join on the card (`device_join.STATS`), one grouped
   device aggregation (`device_agg.STATS`) and one single-form K1
   launch; the first run and the best of three warm runs timed, and the
   device time of the joins' sorts and probes (CUDA events around the
   `ops/join.py` calls); every (planes, constants) the runs gave K1's
   single form captured by wrapping the wrapper from here; counts set
   to 0 just before this phase and read after;
   6f. the cache under a memory budget: W is the bytes the session's
   cache holds for the columns of the bench's six queries and TPC-H q12,
   q14 and q19 (`pressure_queries`, `pressure_working_set`), the cap
   W // 4; two fresh sessions at the cap on the same parquet, each with
   its own cache directory: the default policy (a first run and one
   warm run of each query, and phase 9's profiled run) and
   `liquid-no-squeeze` (a first run and one warm run of the bench's six
   queries): phase 6g's time comes out of this phase's; every answer of
   the first and last run equal to pyarrow, `memory_used <= cap` after
   every run, disk writes in both, and in the default session squeezes,
   an entry seen squeezed and a read from one (`squeeze_io_reads` or
   `squeeze_io_saved`), and the first squeezed float block filtered
   through the cache's squeeze IO (`SqueezedFloatArray.filter`), equal
   to pyarrow with one `squeeze_io_reads` counted; K1 launches in the
   phase; logged per query: warm
   best, first run, busy and idle share, K1 launches per run in both
   forms; per session: `by_state`, the disk and squeeze counters, the
   store file's bytes, `DiskIoGuard`'s read and write bytes and peak
   device memory; every (planes, constants) K1's single form got
   captured, those of a squeezed array's compare labelled narrow;
   counts set to 0 just before this phase and read after;
   6g. the storage slice (its files written in phase 5):
   a. TPC-H at this run's scale with the specification's DECIMAL(15,2)
   money and quantity columns (`lineitem` with its page index) in a
   fresh session on the card (`run_decimal_path`): a first run of a
   narrow `l_orderkey` range inside one row group, which must seed its
   zones from the page index and prune batches, then q6, q14, q19,
   `sum(l_quantity) GROUP BY l_returnflag` and `count(*) WHERE
   l_quantity < 24`; every answer equal to pyarrow on the decimal file
   (decimals exact) and, cast to float64, to the same query on the
   float session (rtol 1e-9); the fused routes pass each on naming
   "decimal column"; every K1 single-form input captured;
   b. JSONBench (`run_json_path`): `--events` bluesky-like events
   (`bench/json_bench.py`, seed 8) and its five `variant_get` queries in
   a fresh uncapped session and one capped at `JSON_CAP_FRACTION` of the
   event column's bytes; answers equal to a `json` + `Counter` oracle;
   in the capped session `memory_used <= cap`, squeezes, disk writes and
   at least `JSON_MIN_SHREDDED` reads served from shredded paths in the
   warm runs (the uncapped session
   has no unprofiled warm run, `JSON_WARM_RUNS`: its profiled run's
   answer is checked, its warm best and idle share are None);
   c. ClickBench q19 over a copy of the hits rows with bloom filters on
   UserID, read through `StoreFile(ByteCache(LocalStore(dir)))`
   (`run_pruning_path`): no row, as pyarrow; the first run's
   `bloom_prunes` equal to the row-group count; the bytes fetched
   through the byte cache under a quarter of the file's;
   per query: first run, warm best, device busy and idle share, K1
   launches per run and the cache counters; counts set to 0 just before
   this phase and read after;
   6h. windows and grouping sets over TPC-DS at this run's scale (its
   tables written in phase 5; SF 1 is `store_sales` 2,880,000 rows and
   `web_sales` 720,000) in a fresh session on the card
   (`run_tpcds_path`): q98 (a window sum over a grouped star join), q27
   (ROLLUP with `grouping()`), q86 (`rank()` over a ROLLUP) and q51
   (running sums, a full outer join and a running max), one first run and
   `TPCDS_WARM_RUNS` warm runs each, every answer equal to pyarrow
   (`bench/oracle.py`, the tie rule of a LIMIT cut); in the phase, the
   executor's `windows` and `grouping_sets` counters and K1's launches
   (the inner queries' scans and probes) above 0; per query: first run,
   warm best, device busy and idle share, K1 launches per run; counts set
   to 0 just before this phase and read after;
   6i. multi-device execution (`liquid_tpu_torch/parallel/`) on a mesh of
   `DIST_SHARDS` shards on the one card (`make_mesh(devices=["cuda:0"] *
   4)`), over the files of phase 5 (TPC-H, the hits rows, TPC-DS), each
   table registered with only the columns its queries name
   (`dist_columns`, logged): the reference's distributed sets as
   written -- TPC-H {1, 3, 5, 6, 9, 10, 11, 12, 14, 15, 16, 18, 19},
   ClickBench {0-17, 29-33} and TPC-DS `DIST_TPCDS_SUPPORTED` -- one
   first run and `DIST_WARM_RUNS` warm runs each (`run_dist_path`);
   TPC-H and ClickBench answers equal to pyarrow (`oracle.DIST_TPCH`,
   `oracle.DIST_CB`, the tie rule of a LIMIT cut), TPC-DS answers equal
   to the port's single-device session on the same files
   (`dist_tpcds_expect`, run before the counts are reset); every run
   counted distributed (`route_stats`, no single-device route), the
   exchanges' overflow 0, and K4's launches (its fused form) in every run
   equal to the plans' count (`DIAG["k4_planned"]`: ceil(D / 16) per
   shard per table scan with a bit-plane predicate, D its descriptors),
   above 0 and below the phase's bit-plane predicates over the shards
   (the single form's count); per query: first run, warm times, K4
   launches and bit-plane predicates per run, the collectives and their
   bytes, the exchanges, their rows and balance, and the scan's bytes;
   `ds_q37` and `ds_q82` (`DIST_PROFILED`) once more under
   torch.profiler (device busy, idle share); one shard's `l_shipdate`
   planes, and the first shard's fused selections of `tpch_q6` and of
   `ds_q37`'s largest scan (`DIST_SELECT_SETS`), kept for phase 10;
   counts set to 0 just before this phase and read after.  Four shards share the card: the phase
   checks the algorithm and the launches, not an interconnect;
   6j. the disaggregated path (`liquid_tpu_torch/server/`): the Flight
   service and the admin HTTP server on 127.0.0.1 (port 0) over the
   session phases 5-6b filled, installed as `bench/clients.serve`
   installs its session, its cache asserted on the card
   (`run_server_path`); `cb_filter`, `cb_groupby`, `tpch_q6`, `tpch_q1`
   and `tpch_q3` from `bench/main.py`'s list through
   `LiquidCacheClient.sql` (one partition): each answer equal to
   pyarrow, the first fetch's route counters and K1 / K2 launches equal
   to the second of two in-process runs just before it (K1 also to
   `K1_PER_RUN`), a repeated fetch equal and launching nothing (the
   plan's result is kept per handle); the scan `SERVER_SCAN` over four partitions, twice:
   a partitionable scan of `hits`, each partition executing only its
   row group, the rows as a multiset equal to pyarrow's filter of the
   file and as many as `cb_filter` counts, K1 launched in each run; the
   admin routes (`/cache_stats`, `/cache_info`, `/execution_plans` with
   every plan executed, `/execution_metrics?handle=`), a cache trace
   around the second scan flushed by `/stop_trace?path=` and rendered by
   `devtools/trace_viz.py`, and the client's trace continued by the
   server's `server.fetch` span; then `/reset_cache` on a service of its
   own over a fresh session of `hits` (`server_reset_check`: a reset of
   the main session would make phase 9 transcode every column again),
   `cb_filter` equal to pyarrow before and after it from one client,
   whose stale plan handle costs it exactly one registration; every server
   stopped in a `finally`, each within its time limit; per query the
   Flight time beside the in-process warm best of the earlier phases;
   counts set to 0 just before this phase and read after;
   6k. the rest of the harness, counts set to 0 just before this phase
   and read after (`run_suites_path`):
   a. the 14 micro benchmarks (`bench/micro.py`) at full size on the
   card, each result logged, every value finite and >= 0, the FSST and
   primitive ratios below 1, the eviction benchmark squeezing or writing
   to disk, `bitpacking`'s unpack equal to `unpack_bitplanes_host` on the
   same planes, and K1's launches in `filter_pushdown` equal to the
   count the cache's width buckets predict (`k1_groups` per evaluation);
   b. the StackOverflow-DBA suite at 20,000 users and 200,000 posts
   (400,000 comments, 800,000 votes, 60,000 badges; written in phase
   5's pool) in three sessions on the card: `liquid` and `arrow` at the
   reference CI's 10 MB cap and `liquid` uncapped, the eight queries a
   first and a warm run each, every answer equal to pyarrow
   (`oracle.SO_ORACLES`), memory within the cap after every query and
   the capped sessions squeezing or spilling, each query's ms and its K1
   and K2 launches logged (K2 where `_k2_plan` takes a grouped query);
   c. the reference's schedule workloads (`bench/schedules.py`: budget,
   concurrent inserts into a cache on the card, eviction advice) under
   `shuttle.check` at the reference's 60, 12 and 40 schedules, then one
   recorded insert schedule replayed to the same trace and entries;
   d. the differential fuzz cases (`bench/fuzz.py`) on the card: string
   seeds 0-59 and integer seeds 0-39, then new seeds from 1,000,000
   until `FUZZ_SECONDS` have passed, each mask equal to pyarrow's;
   e. the six runnable examples of `examples/torch/`, called in-process
   with `--device cuda`;
7. K1's interval form checked bit-exact against its plain version and
   timed (CUDA events, L2 flushed before each timed call) on the exact
   (planes, lo, hi) the main path gave it -- the single-table plans'
   and the star phase's, dimension builds included -- beside the two
   single-constant launches it replaces (as a pair after one flush, and
   one alone), the plain version and the byte bound; its single form
   checked bit-exact on every input phase 6e captured and the largest
   timed beside its plain version and byte bound (`time_k1_single`); and
   on every input phase 6f captured, the largest narrow one timed the
   same way (`time_k1_narrow`); and on every input phase 6g's decimal
   queries gave it, the largest timed the same way;
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
   read after: six queries answered in `liquid` mode (routes fused and,
   `tpch_q3`, star) and in `arrow` mode (every route classic), the two
   modes' answers equal to each other and to pyarrow, `arrow_ms` and
   `vs_baseline` reported, the micro line's K3 launches (at least 256);
   its JSON line is
   printed by it.  The launches of its operator timing loops are
   counted apart: each kernel's `launches` is the query phases' and the
   micro line's, `launches_by_phase` splits it and adds the loops';
10. K3 and K4 timed (CUDA events, L2 flushed) on the micro line's input,
   w = 10 over 2^27 rows, beside their plain versions and byte bounds;
   K4 also on phase 6i's per-shard `l_shipdate` planes (TPC-H lineitem
   over four shards); K4's fused form on phase 6i's two shard selections
   (`time_select`), cold and warm, beside the composed chain it replaces
   (per predicate a single-form K4 launch, its op and the ANDs), its
   plain version and its byte bound.

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


def k1_groups(cache, entry_ids, pred) -> int:
    """K1 single-form launches one `eval_predicate_many` call must make:
    one per (width bucket, op) among the resident bit-plane blocks whose
    predicate needs a compare (a bucket of one block included), plus one
    per threshold of each resident ALP float block it evaluates one by
    one."""
    from liquid_tpu_torch.arrays.float_alp import LiquidFloatArray
    from liquid_tpu_torch.arrays.primitive import LiquidPrimitiveArray
    from liquid_tpu_torch.cache import core
    buckets, floats = set(), 0
    with cache._lock:
        for eid in entry_ids:
            e = cache._entries.get(eid)
            if e is None or e.state != core.MEMORY_LIQUID:
                continue
            p = e.payload
            if isinstance(p, LiquidPrimitiveArray):
                plan = p.packed_plan(pred)
                if plan is not None and plan[0] == "cmp":
                    buckets.add((p.planes_np.shape[0], plan[2]))
            elif isinstance(p, LiquidFloatArray) and pred.op in (
                    "eq", "ne", "lt", "lt_eq", "gt", "gt_eq") and isinstance(
                    pred.literal, (int, float)) and not isinstance(
                    pred.literal, bool) and pred.literal == pred.literal:
                strict = {"lt": (False,), "gt_eq": (False,),
                          "lt_eq": (True,), "gt": (True,)}.get(
                              pred.op, (False, True))
                top = (1 << p.width) - 1 if p.width else 0
                floats += sum(0 < p.lower_bound(float(pred.literal), st)
                              <= top for st in strict)
    return len(buckets) + floats


def classic_k1_per_run(scans) -> int:
    """K1 single-form launches a classic run must make, from the scans it
    handed the cache (`k1_groups` of each `eval_predicate_many` call):
    one per row group, pushdown predicate and width bucket."""
    return sum(scans)


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


#: phase 4b's word counts for K4's fused form: 46,863 is a 6i shard of
#: TPC-H SF 1 lineitem
SELECT_CHECK_WORDS = (1, 255, 46_863, 1 << 22)
#: an interval's two ops in phase 4b, lower bound first
SELECT_PAIRS = (("gt_eq", "lt_eq"), ("gt", "lt"), ("gt_eq", "lt"),
                ("gt", "lt_eq"), ("ne", "lt_eq"), ("eq", "gt_eq"))


def check_select(torch, dev) -> int:
    """Phase 4b, K4's fused form: `select_planes` vs `select_planes_ref`,
    bit-exact, over W in {1, 255, 46863, 2^22} words and P in {1, 2, 5,
    16, 17} predicates per call (17 lone columns: two chained launches);
    widths 0..64 mixed within a call (every width at each W but 2^22,
    which takes 30 of them), every op, interval pairs (every third
    predicate the second bound on the column before), validity present
    and absent, constants 0, 2^w-1, 2^w, 2^64-1 and one inside the
    width; launches equal `select_launches`, sel left as it was, and a
    CPU tensor among CUDA ones refused -> max abs error (0)."""
    import itertools
    import numpy as np
    from liquid_tpu_torch.ops import bitpack_cuda as k
    gen = torch.Generator(device=dev).manual_seed(1313)
    rng = np.random.default_rng(1313)
    ops = k.SELECT_OPS

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def pool(w):
        top = (1 << w) - 1
        out = [0, top, (1 << 64) - 1,
               int(rng.integers(0, top + 1, dtype=np.uint64))]
        return out + [1 << w] if w < 64 else out

    worst = 0
    for n_words in SELECT_CHECK_WORDS:
        widths = itertools.cycle(int(w) for w in rng.permutation(65))
        for rnd in range(1 if n_words == 1 << 22 else 3):
            for n_preds in (1, 2, 5, 16, 17):
                sel = ~(words(n_words) & words(n_words))
                preds = []
                for i in range(n_preds):
                    if i % 3 == 2:
                        planes, _c, _op, valid = preds[-1]
                        cs = pool(planes.shape[0])
                        lo, hi = sorted(cs[j] for j in rng.choice(len(cs), 2))
                        lo_op, hi_op = SELECT_PAIRS[(i + rnd) % 6]
                        preds[-1] = (planes, lo, lo_op, valid)
                        preds.append((planes, hi, hi_op, valid))
                        continue
                    w = next(widths)
                    valid = ~(words(n_words) & words(n_words)
                              & words(n_words)) if (i + rnd) % 2 else None
                    cs = pool(w)
                    preds.append((words(w, n_words), cs[(i + rnd) % len(cs)],
                                  ops[(i + rnd) % len(ops)], valid))
                if n_preds == 17 and rnd == 0:  # 17 descriptors: chained
                    preds = [(words(next(widths), n_words), 1 << 63,
                              ops[i % len(ops)], None) for i in range(17)]
                ref = k.select_planes_ref(sel, preds)
                before = sel.clone()
                n0 = k.LAUNCHES["cmp_const_planes"]
                got = k.select_planes(sel, preds)
                torch.cuda.synchronize()
                launched = k.LAUNCHES["cmp_const_planes"] - n0
                if launched != k.select_launches(sel, preds):
                    raise AssertionError(
                        f"K4's fused form launched {launched} times for "
                        f"{n_preds} predicates, planned "
                        f"{k.select_launches(sel, preds)}")
                err = _max_abs_err(torch, [got, sel], [ref, before])
                if err:
                    raise AssertionError(
                        f"K4's fused form != plain at W {n_words}, P "
                        f"{n_preds}, round {rnd}: max abs err {err}")
                worst = max(worst, err)
                del preds, ref, got, before
    sel = words(255)
    try:
        k.select_planes(sel, [(words(3, 255).cpu(), 1, "lt", None)])
    except ValueError:
        pass
    else:
        raise AssertionError("K4's fused form took a CPU stack beside a "
                             "CUDA sel")
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


def time_k34(torch, shard_planes) -> dict:
    """Phase 10: K3 and K4 timed (CUDA events, L2 flushed) on the micro
    line's input -- w = 10 over 2^27 rows, uniform values, seed 0 --
    beside their plain versions and byte bounds; K4 also on one shard's
    planes from phase 6i (`shard_planes`, int32[w, W]) against a
    constant inside its width, under "shard"."""
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
    width, n_words = shard_planes.shape
    c = int(rng.integers(1, 1 << width))
    got = k.cmp_const_planes(shard_planes, c)
    err = _max_abs_err(torch, got, k.cmp_const_planes_ref(shard_planes, c))
    if err:
        raise AssertionError(f"K4 != plain on 6i's shard planes: {err}")
    bound, by, nbytes = k34_bound_ms(width, n_words, 2)
    out["shard"] = dict(
        w=width, n_words=n_words, c=c, bytes=nbytes,
        ms=time_cold(torch, lambda: k.cmp_const_planes(shard_planes, c),
                     flush, 50),
        warm_ms=time_warm(torch, lambda: k.cmp_const_planes(
            shard_planes, c), 100),
        plain_ms=time_cold(torch, lambda: k.cmp_const_planes_ref(
            shard_planes, c), flush, 10),
        bound_ms=bound, bound_by=by, max_abs_err=err)
    log(f"[k34] cmp_const_planes on a 6i shard: {json.dumps(out['shard'])}")
    return out


def select_bound_ms(sel, preds):
    """(least time in ms, what bounds it, bytes) of one fused selection:
    each column's planes read once (a descriptor's two bounds share
    them), sel and each validity read, sel written, vs ~10 word
    operations per plane per word (two compares) over the word rate."""
    from liquid_tpu_torch.ops import bitpack_cuda as k
    descs = k._descriptors(k._select_check(sel, preds))
    n_words = sel.shape[0]
    planes = sum(d[0].shape[0] for d in descs)
    nbytes = 4 * n_words * (planes + 2 + sum(d[5] is not None
                                             for d in descs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * planes * n_words / WORD_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def composed_select(sel, preds):
    """The chain the fused form replaces (the mesh's selection before
    it): per predicate one K4 single-form launch, its op, and the ANDs."""
    from liquid_tpu_torch.ops import bitpack_cuda as k
    from liquid_tpu_torch.ops.bitpack import combine_op
    for planes, c, op, valid in preds:
        sel = sel & combine_op(*k.cmp_const_planes(planes, c), op)
        if valid is not None:
            sel = sel & valid
    return sel


def time_select(torch, sets: dict) -> dict:
    """Phase 10, K4's fused form on the (sel, predicates) phase 6i gave it
    on its first shard (`sets`: `tpch_q6`'s l_shipdate interval and the
    largest scan of `ds_q37`): checked bit-exact against the plain
    version and the composed chain, then timed cold (L2 flushed) and warm
    (back to back) beside that chain, the plain version and the bound."""
    from liquid_tpu_torch.ops import bitpack_cuda as k
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out = {}
    for name, (sel, preds) in sets.items():
        got = k.select_planes(sel, preds)
        err = _max_abs_err(torch, [got, got], [
            k.select_planes_ref(sel, preds), composed_select(sel, preds)])
        if err:
            raise AssertionError(f"K4's fused form != plain on 6i's {name}: "
                                 f"{err}")
        bound, by, nbytes = select_bound_ms(sel, preds)
        row = dict(
            n_words=sel.shape[0], preds=[
                dict(w=p.shape[0], c=int(c), op=op, valid=v is not None)
                for p, c, op, v in preds],
            launches=k.select_launches(sel, preds), bytes=nbytes,
            ms=time_cold(torch, lambda: k.select_planes(sel, preds), flush,
                         50),
            warm_ms=time_warm(torch, lambda: k.select_planes(sel, preds),
                              200),
            composed_ms=time_cold(torch, lambda: composed_select(sel, preds),
                                  flush, 50),
            composed_warm_ms=time_warm(
                torch, lambda: composed_select(sel, preds), 200),
            plain_ms=time_cold(torch, lambda: k.select_planes_ref(sel, preds),
                               flush, 10),
            bound_ms=bound, bound_by=by, max_abs_err=err)
        out[name] = row
        log(f"[select] {name} on a 6i shard: {json.dumps(row)}")
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
    if res["not_ported"]:
        raise AssertionError(f"harness not_ported {res['not_ported']}")
    # the entry point raises when the modes' answers differ
    if res["arrow_ms"] is None or res["vs_baseline"] is None \
            or set(res["arrow_ms"]) != set(res["queries_ms"]):
        raise AssertionError(f"harness arrow mode: {res['arrow_ms']} "
                             f"{res['vs_baseline']}")
    if res["arrow_routes"] != {q: "classic" for q in res["queries_ms"]}:
        raise AssertionError(f"harness arrow routes {res['arrow_routes']}")
    log(f"[harness] arrow over liquid {res['vs_baseline']}: "
        f"{json.dumps(res['vs_baseline_per_query'])}")
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


def check_members(torch, ctx, paths: dict, device="cuda") -> dict:
    """Phase 5's member checks on the card, over the main path's cache:
    `LiquidArray.filter` on every cached block of hits' `AdvEngineID`
    (primitive) and `URL` (byte-view) under `cb_filter`'s selection, and
    of lineitem's `l_discount` (float; hits has no float column) under
    `l_quantity < 24` (q6's), each selection the cache's encoded
    evaluation on the card; each column's blocks together equal to
    pyarrow's `filter` of the file.  `BoolMask.from_bools` of 8,191 rows
    on the card equal to its CPU result -> per column blocks, rows, ms."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from liquid_tpu_torch.arrays.base import LiquidArray, Predicate
    from liquid_tpu_torch.device import words_to_numpy
    from liquid_tpu_torch.ops import mask as mops
    report = {}
    for table, col, pcol, pred, keep in (
            ("hits", "AdvEngineID", "AdvEngineID", Predicate("ne", 0),
             lambda c: pc.not_equal(c, 0)),
            ("hits", "URL", "AdvEngineID", Predicate("ne", 0),
             lambda c: pc.not_equal(c, 0)),
            ("lineitem", "l_discount", "l_quantity", Predicate("lt", 24),
             lambda c: pc.less(c, 24))):
        pt = ctx._tables[table]
        cache = pt.cache
        parts = []
        t0 = time.perf_counter()
        for rg in range(pt.num_row_groups):
            nb = pt.num_batches(rg)
            masks = cache.eval_predicate_many(
                [pt.entry_id(rg, pcol, b) for b in range(nb)], pred)
            for b, m in enumerate(masks):
                blk = cache._entries[pt.entry_id(rg, col, b)].payload
                if m is None or m.bits.device.type != ctx.device.type \
                        or not isinstance(blk, LiquidArray):
                    raise AssertionError(f"5: {table}.{col} block {rg}/{b} "
                                         f"has no encoded selection or block")
                got = blk.filter(m.to_selection())
                parts.append(got.cast(got.type.value_type)
                             if pa.types.is_dictionary(got.type) else got)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t = pq.read_table(paths[table], columns=sorted({col, pcol}))
        want = t[col].filter(keep(t[pcol])).combine_chunks()
        got = pa.concat_arrays(parts)
        if not got.equals(want.cast(got.type)):
            raise AssertionError(f"5: {table}.{col} filtered on the card "
                                 f"!= pyarrow ({len(got)} / {len(want)})")
        report[f"{table}.{col}"] = dict(blocks=len(parts), rows=len(got),
                                        ms=ms)
    rng = np.random.default_rng(16)
    bools = torch.from_numpy(rng.random(8191) < 0.5)
    valid = torch.from_numpy(rng.random(8191) < 0.9)
    host = mops.BoolMask.from_bools(bools, valid)
    card = mops.BoolMask.from_bools(bools.to(device), valid.to(device))
    if card.bits.device.type != torch.device(device).type or any(
            not np.array_equal(words_to_numpy(a), words_to_numpy(b))
            for a, b in ((card.bits, host.bits), (card.valid, host.valid))):
        raise AssertionError("5: BoolMask.from_bools on the card != CPU")
    report["from_bools_words"] = int(card.bits.numel())
    return report


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
    from liquid_tpu_torch.sql import fused_agg
    out = []
    for name, table in ctx._tables.items():
        for probe in fused_agg.table_state(table).dim_builds.values():
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
            plans = ctx._exec.star_plans
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
    from liquid_tpu_torch.cache.core import LiquidCache
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import join as jops
    from liquid_tpu_torch.sql import exec as sql_exec
    calls, events, scans = [], [], []
    wrapped = k1.cmp_const_many
    many = LiquidCache.eval_predicate_many
    join_ops = {n: getattr(jops, n) for n in ("sort_build", "probe_bounds",
                                               "expand_matches",
                                               "matched_flags")}

    def capture(planes, cs):
        if planes.shape[0] * planes.shape[1]:
            calls.append((planes, cs))
        return wrapped(planes, cs)

    def scan(cache, entry_ids, pred):
        scans.append(k1_groups(cache, entry_ids, pred))
        return many(cache, entry_ids, pred)

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
    LiquidCache.eval_predicate_many = scan
    for name, fn in join_ops.items():
        setattr(jops, name, timed(fn))
    report, inputs, seen = {}, [], set()
    try:
        for qname, sql, counter in classic_queries():
            torch.cuda.reset_peak_memory_stats()

            def run_once():
                st = dict(sql_exec.STATS)
                launches = k1.LAUNCHES["cmp_const_many"]
                calls.clear()
                events.clear()
                scans.clear()
                out = run_statements(ctx, sql)
                torch.cuda.synchronize()
                if sql_exec.STATS[counter] <= st[counter]:
                    raise AssertionError(f"{qname} left the classic route: "
                                         f"{sql_exec.STATS} vs {st}")
                join_ms = sum(s.elapsed_time(e) for s, e in events)
                return (out, k1.LAUNCHES["cmp_const_many"] - launches,
                        list(calls), join_ms, len(events),
                        classic_k1_per_run(scans))

            t0 = time.perf_counter()
            out, first_k1, first_calls, first_join_ms, _, want = run_once()
            t_first = time.perf_counter() - t0
            outs, warm = {"first": out}, []
            singles, wants = [len(first_calls)], [want]
            for _ in range(3):
                t0 = time.perf_counter()
                (out, per_run, warm_calls, join_ms, join_calls,
                 want) = run_once()
                warm.append(time.perf_counter() - t0)
                singles.append(len(warm_calls))
                wants.append(want)
            outs["last warm"] = out
            for what, got in outs.items():
                if not oracle.same_table(got, expect[qname],
                                         oracle.CUTS.get(qname)):
                    raise AssertionError(f"{qname} ({what} run): port "
                                         f"{got.to_pylist()[:2]} != pyarrow")
            if singles != wants:
                raise AssertionError(f"{qname}: K1 single-form launches per "
                                     f"run {singles}, expected {wants} "
                                     f"(classic_k1_per_run)")
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
        LiquidCache.eval_predicate_many = many
        for name, fn in join_ops.items():
            setattr(jops, name, fn)
    return report, inputs


#: phase 6f: the bench's six queries, then TPC-H q12, q14 and q19 (with
#: q1, q3 and q6 the reference's memory-pressure subset,
#: `tests/test_memory_pressure.py`)
def pressure_queries():
    from liquid_tpu_torch.bench.main import queries
    from liquid_tpu_torch.bench.tpch_queries import QUERIES
    return [(n, sql) for n, _c, _r, sql in queries(1, 1)] + [
        (f"tpch_q{q}", QUERIES[q]) for q in (12, 14, 19)]


def pressure_working_set(ctx, qs) -> int:
    """W: the bytes the session's cache holds for the columns the queries
    name (the sum of their entries' `mem_bytes`), transcoding nothing."""
    import re
    cols = set()
    for t in ctx._tables.values():
        for i, c in enumerate(t.column_names):
            if any(re.search(rf"\b{re.escape(c)}\b", sql) for _n, sql in qs):
                cols.add((t.file_id, i))
    cache = ctx.cache
    with cache._lock:
        return sum(e.mem_bytes for eid, e in cache._entries.items()
                   if (eid >> 48, (eid >> 16) & 0xFFFF) in cols)


def squeezed_float_filter(torch, ctx, cache):
    """`SqueezedFloatArray.filter` on the first squeezed float entry, every
    third row selected on the card, read through the cache's squeeze IO:
    equal to pyarrow's filter of the same block of the file, with one
    `squeeze_io_reads` counted -> its entry and rows, or None while no
    float entry is squeezed."""
    import numpy as np
    import pyarrow.parquet as pq
    from liquid_tpu_torch.arrays.base import BLOCK_ROWS
    from liquid_tpu_torch.arrays.float_alp import SqueezedFloatArray
    from liquid_tpu_torch.cache import core
    from liquid_tpu_torch.device import words_to_tensor
    from liquid_tpu_torch.ops import mask as mops
    with cache._lock:
        eid = next((i for i, e in cache._entries.items()
                    if e.state == core.MEMORY_SQUEEZED
                    and isinstance(e.payload, SqueezedFloatArray)), None)
        if eid is None:
            return None
        payload = cache._entries[eid].payload
        keep = np.arange(BLOCK_ROWS) % 3 == 0
        sel = words_to_tensor(mops.pack_bools_host(keep), cache.device)
        before = cache.observer.stats.get("squeeze_io_reads")
        got = payload.filter(sel, core._SqueezeIo(cache, eid))
        reads = cache.observer.stats.get("squeeze_io_reads") - before
    t = next(t for t in ctx._tables.values() if t.file_id == eid >> 48)
    rg, col, b = (eid >> 32) & 0xFFFF, (eid >> 16) & 0xFFFF, eid & 0xFFFF
    block = pq.ParquetFile(t.path).read_row_group(rg, columns=[
        t.column_names[col]]).column(0).combine_chunks().slice(
        b * BLOCK_ROWS, BLOCK_ROWS)
    if not got.equals(block.filter(keep[:len(block)])) or reads != 1:
        raise AssertionError(f"6f: SqueezedFloatArray.filter of {eid:#x} "
                             f"!= pyarrow, or {reads} squeeze IO reads")
    return dict(entry=f"{eid:#x}", column=t.column_names[col],
                rows=len(got), squeeze_io_reads=reads)


def run_pressure_path(torch, paths: dict, expect: dict, cap: int):
    """Phase 6f: the cache under a memory budget -> (report, [(planes, cs,
    label)] of every K1 single-form input the phase gave).  Two fresh
    sessions at `cap`, each with its own cache directory: the default
    policy (`TranscodeSqueezeEvict`) on the nine queries and
    `liquid-no-squeeze` (`bench/runner.make_session`) on the bench's six,
    each query a first run and one warm run.  Every answer
    of the first and the last
    run equals pyarrow; `memory_used <= cap` after every run; disk writes
    in both; in the default session squeezes, an entry seen squeezed and
    a read from one, and, once its summary is taken, one
    `squeezed_float_filter` on the still-open cache.  A compare made
    inside a squeezed array's predicate is labelled narrow."""
    import tempfile
    import threading
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.arrays import hybrid
    from liquid_tpu_torch.arrays.float_alp import SqueezedFloatArray
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.bench.runner import DiskIoGuard, make_session
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    qs = pressure_queries()
    inputs, counts, state = [], {"single": 0, "interval": 0}, \
        threading.local()
    single, interval = k1.cmp_const_many, k1.in_interval_many
    squeezed = (hybrid.SqueezedPrimitiveArray, hybrid.SqueezedQuantizedArray,
                hybrid.SqueezedByteViewArray, hybrid.SqueezedDate32Array,
                SqueezedFloatArray)
    evals = {c: c.try_eval_predicate for c in squeezed}

    def capture(planes, cs):
        if planes.shape[0] * planes.shape[1]:
            counts["single"] += 1
            inputs.append((planes, cs, getattr(state, "label", "")))
        return single(planes, cs)

    def capture_interval(planes, lo, hi):
        if planes.shape[0] * planes.shape[1]:
            counts["interval"] += 1
        return interval(planes, lo, hi)

    def narrow(fn):
        def run(self, pred, io, device):
            state.label = "narrow"
            try:
                return fn(self, pred, io, device)
            finally:
                state.label = ""
        return run

    def session(mode, cache_dir):
        if mode == "default":
            ctx, cache = (LiquidCacheLocalBuilder().with_max_memory_bytes(cap)
                          .with_cache_dir(cache_dir).build())
        else:
            ctx, cache = make_session(mode, cap, cache_dir)
        for name, p in paths.items():
            ctx.register_parquet(name, p)
        return ctx, cache

    report = {}
    k1.cmp_const_many, k1.in_interval_many = capture, capture_interval
    for c in squeezed:
        c.try_eval_predicate = narrow(evals[c])
    try:
        # one warm run per query, and the no-squeeze session runs the
        # bench's six queries only: the storage phase's time comes out of
        # this phase's
        for mode, warm_runs, mode_qs in (
                ("default", 1, qs), ("liquid-no-squeeze", 1, qs[:6])):
            torch.cuda.reset_peak_memory_stats()
            with tempfile.TemporaryDirectory() as d, DiskIoGuard() as io:
                ctx, cache = session(mode, d)
                rows, seen_squeezed, float_filter = {}, 0, None
                t_mode = time.perf_counter()
                for qname, sql in mode_qs:
                    per_run, times = [], []
                    for run in range(1 + warm_runs):
                        state.label = ""
                        c0 = dict(counts)
                        t0 = time.perf_counter()
                        out = ctx.sql(sql).to_arrow()
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        per_run.append({k: counts[k] - c0[k] for k in c0})
                        st = cache.stats()
                        if st["memory_used"] > cap:
                            raise AssertionError(
                                f"6f {mode} {qname}: memory_used "
                                f"{st['memory_used']} > cap {cap}")
                        seen_squeezed = max(seen_squeezed, st["by_state"].get(
                            "memory_squeezed", 0))
                        if run in (0, warm_runs) and not oracle.same_table(
                                out, expect[qname], oracle.CUTS.get(qname)):
                            raise AssertionError(
                                f"6f {mode} {qname} (run {run}): port "
                                f"{out.to_pylist()[:2]} != pyarrow")
                    row = dict(first_run_s=times[0],
                               warm_best_ms=min(times[1:]) * 1e3,
                               warm_ms=[t * 1e3 for t in times[1:]],
                               k1_per_run=per_run)
                    if mode == "default":
                        bd = device_breakdown(torch, ctx, sql,
                                              row["warm_best_ms"],
                                              settle=False)
                        row.update(device_busy_ms=bd["device_busy_ms"],
                                   idle_share=bd["idle_share"],
                                   device_ops=bd["device_ops"])
                    row["stats"] = {k: st[k] for k in (
                        "memory_used", "disk_used", "squeezes", "disk_reads",
                        "disk_writes", "squeeze_io_reads", "squeeze_io_saved",
                        "hydrations")}
                    rows[qname] = row
                    log(f"[pressure] {mode} {qname}: {json.dumps(row)}")
                st = cache.stats()
                summary = dict(
                    seconds=time.perf_counter() - t_mode,
                    by_state=st["by_state"], entries=st["entries"],
                    max_squeezed_entries=seen_squeezed,
                    store_file_bytes=cache.store.file_bytes,
                    **{k: st[k] for k in (
                        "memory_used", "disk_used", "squeezes", "disk_reads",
                        "disk_writes", "squeeze_io_reads",
                        "squeeze_io_saved", "hydrations", "transcodes")})
                # after the summary, so that its read counts in no query's
                # stats and cannot meet the squeezed tier's gate
                if mode == "default":
                    float_filter = squeezed_float_filter(torch, ctx, cache)
                del ctx, cache
            summary.update(io_read_bytes=io.read_bytes,
                           io_write_bytes=io.write_bytes,
                           max_memory_allocated=torch.cuda
                           .max_memory_allocated())
            log(f"[pressure] {mode} summary: {json.dumps(summary)}")
            if summary["disk_writes"] <= 0:
                raise AssertionError(f"6f {mode}: no disk write")
            if mode == "default" and (
                    summary["squeezes"] <= 0 or seen_squeezed <= 0
                    or summary["squeeze_io_reads"]
                    + summary["squeeze_io_saved"] <= 0):
                raise AssertionError(f"6f default: the squeezed tier did not "
                                     f"engage: {summary}")
            if mode == "default":
                if float_filter is None:
                    raise AssertionError("6f default: no squeezed float "
                                         "block to filter")
                summary["squeezed_float_filter"] = float_filter
                log(f"[pressure] squeezed float filter "
                    f"{json.dumps(float_filter)}")
            report[mode] = {"queries": rows, "summary": summary}
    finally:
        k1.cmp_const_many, k1.in_interval_many = single, interval
        for c in squeezed:
            c.try_eval_predicate = evals[c]
    return report, inputs


# -- phase 6g: the storage slice ----------------------------------------------

#: JSONBench's smallest published size (ClickHouse/JSONBench): 1M events
STORAGE_EVENTS = 1_000_000
#: the capped JSONBench session's cap, as a multiple of the event column's
#: arrow bytes.  Each block is charged the bytes its slice of the row group
#: references, so the column's 123 arrow blocks weigh about the column,
#: and at 1.25x nothing squeezes; `bench/json_caps.py` on the CPU at 1M
#: events: 64 squeezes and 134 warm reads served shredded at 0.5x
JSON_CAP_FRACTION = 0.5
#: the fewest warm reads the capped session must serve from resident
#: shredded paths (`squeeze_io_saved`)
JSON_MIN_SHREDDED = 5


def write_once(path: str, write, *args) -> str:
    """`write(tmp, *args)` and rename the file to `path`, unless `path`
    exists -> path."""
    if not os.path.exists(path):
        write(path + ".tmp", *args)
        os.replace(path + ".tmp", path)
    return path


def write_decimals(dst: str, src: str, page_index: bool) -> None:
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench.tpch_data import with_spec_decimals
    pq.write_table(with_spec_decimals(pq.read_table(src)), dst,
                   row_group_size=1 << 20, write_page_index=page_index)


def write_events(dst: str, events: int) -> None:
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench import json_bench
    pq.write_table(json_bench.generate(events), dst)


def write_bloom_hits(dst: str, src: str) -> None:
    import pyarrow
    import pyarrow.parquet as pq
    try:
        pq.write_table(pq.read_table(src), dst, row_group_size=1 << 20,
                       write_page_index=True,
                       bloom_filter_options={"UserID": True})
    except TypeError as e:
        raise AssertionError(f"phase 6g: pyarrow {pyarrow.__version__} "
                             f"writes no bloom filters: {e}") from e


def events_job(data_dir: str, events: int) -> tuple:
    return (os.path.join(data_dir, f"liquid_bench_events_{events}.parquet"),
            write_events, events)


def storage_jobs(data_dir: str, paths: dict) -> dict:
    """Phase 6g's copies of phase 5's files -> {name: (path, write,
    *args)}: `lineitem` and `part` with the specification's
    DECIMAL(15,2) columns (lineitem with its page index) and `hits` with
    bloom filters on UserID and a page index."""
    def beside(prefix, table):
        return os.path.join(data_dir,
                            prefix + os.path.basename(paths[table]))
    return {"lineitem": (beside("dec_", "lineitem"), write_decimals,
                         paths["lineitem"], True),
            "part": (beside("dec_", "part"), write_decimals, paths["part"],
                     False),
            "hits": (beside("bloom_", "hits"), write_bloom_hits,
                     paths["hits"])}


def write_data(data_dir: str, hits_rows: int, sf: float, events: int,
               tables) -> tuple:
    """Phases 5, 6g, 6h and 6k's files -> (paths, storage paths, TPC-DS
    paths, StackOverflow paths, oracle answers), written in five worker
    processes: hits, TPC-H, the events, TPC-DS and StackOverflow
    together, then the storage copies of `storage_jobs` while this
    process computes the oracle's answers.  Each file is written once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.bench.hits import prepare_hits
    from liquid_tpu_torch.bench.main import prepare_tpch
    with ProcessPoolExecutor(
            5, mp_context=multiprocessing.get_context("spawn")) as pool:
        hits = pool.submit(prepare_hits, hits_rows, data_dir)
        tpch = pool.submit(prepare_tpch, data_dir, sf, tables)
        events = pool.submit(write_once, *events_job(data_dir, events))
        tpcds = pool.submit(prepare_tpcds, data_dir, sf)
        so = pool.submit(prepare_stackoverflow, data_dir, SO_USERS, SO_POSTS)
        paths = {"hits": hits.result(), **tpch.result()}
        copies = {k: pool.submit(write_once, *job) for k, job in
                  storage_jobs(data_dir, paths).items()}
        expect = oracle.answers(paths, list(oracle.ORACLES))
        dspaths = tpcds.result()
        expect.update(oracle.answers(dspaths, list(oracle.TPCDS_ORACLES)))
        sopaths = so.result()
        expect.update(oracle.answers(sopaths, list(oracle.SO_ORACLES)))
        spaths = {k: f.result() for k, f in copies.items()}
        spaths["events"] = events.result()
    return paths, spaths, dspaths, sopaths, expect


def _query_runs(torch, ctx, sql, warm_runs=3, after=None):
    """A first run and `warm_runs` warm runs of `sql` -> (answers of the
    first and the last run, first run s, warm ms, K1 launches per run);
    `after(run)` is called after each run."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    outs, times, k1_runs = [], [], []
    for run in range(1 + warm_runs):
        launches = k1.LAUNCHES["cmp_const_many"]
        t0 = time.perf_counter()
        out = ctx.sql(sql).to_arrow()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        k1_runs.append(k1.LAUNCHES["cmp_const_many"] - launches)
        outs.append(out)
        if after is not None:
            after(run)
    return (outs[0], outs[-1]), times[0], [t * 1e3 for t in times[1:]], \
        k1_runs


_COUNTERS = ("memory_used", "disk_used", "squeezes", "disk_reads",
             "disk_writes", "squeeze_io_reads", "squeeze_io_saved",
             "hydrations", "transcodes", "predicate_evals_on_encoded")


def _row(torch, ctx, sql, first_s, warm_ms, k1_runs) -> dict:
    bd = device_breakdown(torch, ctx, sql, min(warm_ms), settle=False)
    st = ctx.cache.stats()
    return dict(first_run_s=first_s, warm_best_ms=min(warm_ms),
                warm_ms=warm_ms, device_busy_ms=bd["device_busy_ms"],
                idle_share=bd["idle_share"], device_ops=bd["device_ops"],
                k1_per_run=k1_runs,
                stats={k: st.get(k, 0) for k in _COUNTERS},
                by_state=st["by_state"])


def run_decimal_path(torch, fctx, dpaths: dict):
    """Phase 6g-a: TPC-H with DECIMAL(15,2) money columns in a fresh
    session on the card -> (report, [(planes, cs, label)] of every K1
    single-form input).  A first run of a narrow `l_orderkey` range inside
    one row group seeds a zone for each of that row group's batches from
    the page index and prunes by them before any data read (counters read
    after the first run); then q6, q14, q19, `sum(l_quantity) GROUP BY
    l_returnflag` and `count(*) WHERE l_quantity < 24`.  Every answer
    (first and last run) equals pyarrow on the decimal file (decimals
    exact) and, cast to float64, the same query on the float session
    `fctx` (rtol 1e-9); the fused routes pass each on naming "decimal
    column"; K1's single form launches in the phase."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.sql import fused_agg
    calls, inputs = [], []
    wrapped = k1.cmp_const_many

    def capture(planes, cs):
        if planes.shape[0] * planes.shape[1]:
            calls.append((planes, cs))
        return wrapped(planes, cs)

    ctx, cache = LiquidCacheLocalBuilder().with_max_memory_bytes(
        16 << 30).build()
    for name, p in dpaths.items():
        ctx.register_parquet(name, p)
    md = pq.ParquetFile(dpaths["lineitem"]).metadata
    rg = md.num_row_groups // 2
    ci = md.schema.to_arrow_schema().get_field_index("l_orderkey")
    st = md.row_group(rg).column(ci).statistics
    lo = st.min + (st.max - st.min) // 2
    qs = [("dec_orderkey_range",
           f"SELECT sum(l_quantity) AS q FROM lineitem "
           f"WHERE l_orderkey BETWEEN {lo} AND {lo + 200}")]
    qs += [(n, oracle.decimal_sql(n)) for n in oracle.DECIMAL_QUERIES]
    li = pq.read_table(dpaths["lineitem"], columns=["l_orderkey",
                                                    "l_quantity"])
    keep = pc.and_(pc.greater_equal(li["l_orderkey"], lo),
                   pc.less_equal(li["l_orderkey"], lo + 200))
    expect = {"dec_orderkey_range": [pa.array([pc.sum(
        li.filter(keep)["l_quantity"]).as_py()])]}
    del li
    expect.update({n: f(dpaths) for n, f in oracle.DECIMAL_ORACLES.items()})
    table = ctx._tables["lineitem"]
    report, first = {}, {}
    k1.cmp_const_many = capture
    try:
        for qname, sql in qs:
            calls.clear()
            bails = []

            def after(run):
                bails.append((fused_agg.STATS.get("last_bail"),
                              fused_agg.STATS.get("star_last_bail")))
                fused_agg.STATS["last_bail"] = None
                fused_agg.STATS["star_last_bail"] = None
                if run == 0 and qname == "dec_orderkey_range":
                    first.update(seeds=table.pageindex_seeds,
                                 index_zones=table.pageindex_zones,
                                 zone_prunes=table.zone_prunes)

            fused_agg.STATS["last_bail"] = None
            fused_agg.STATS["star_last_bail"] = None
            outs, first_s, warm_ms, k1_runs = _query_runs(torch, ctx, sql,
                                                          after=after)
            if qname == "dec_orderkey_range" and not (
                    first["seeds"] > 0 and first["zone_prunes"] > 0
                    and first["index_zones"] == table.num_batches(rg)):
                # every zone the first run pruned by came from the page
                # index: it set one for each of the row group's batches
                # before their data was read (a zone recorded on load is
                # never overwritten, so it would not count here)
                raise AssertionError(
                    f"6g-a {qname}: the first run seeded {first} from the "
                    f"page index for {table.num_batches(rg)} batches")
            for what, got in zip(("first", "last warm"), outs):
                if not oracle.same_table(got, expect[qname]):
                    raise AssertionError(f"6g-a {qname} ({what} run): port "
                                         f"{got.to_pylist()[:3]} != pyarrow "
                                         f"{[c.to_pylist()[:3] for c in expect[qname]]}")
            if any("decimal column" not in b for b in bails):
                raise AssertionError(f"6g-a {qname} did not leave the fused "
                                     f"routes as a decimal column: {bails}")
            flt = fctx.sql(sql).to_arrow()
            as_float = [c.cast(pa.float64()) if pa.types.is_decimal(c.type)
                        else c for c in outs[1].columns]
            if not oracle.same_table(flt, as_float):
                raise AssertionError(f"6g-a {qname}: decimal "
                                     f"{outs[1].to_pylist()[:3]} != float "
                                     f"{flt.to_pylist()[:3]}")
            inputs += [(p, c, f"decimal {qname} #{i}")
                       for i, (p, c) in enumerate(calls)]
            report[qname] = _row(torch, ctx, sql, first_s, warm_ms, k1_runs)
            report[qname].update(answer=str(outs[1].to_pylist()[:3]),
                                 bails=bails[-1])
            if qname == "dec_orderkey_range":
                report[qname].update(
                    pageindex_seeds_first_run=first["seeds"],
                    pageindex_zones_first_run=first["index_zones"],
                    zone_prunes_first_run=first["zone_prunes"],
                    zone_prunes_all_runs=table.zone_prunes)
            log(f"[decimal] {qname}: {json.dumps(report[qname])}")
    finally:
        k1.cmp_const_many = wrapped
    del ctx, cache
    if not inputs:
        raise AssertionError("6g-a: no K1 single-form launch")
    return report, inputs


#: JSONBench's unprofiled warm runs per query, by session: a run parses
#: every JSON block it does not read shredded (4-10 s per query at 1M
#: events on the host), so the phase keeps to the time limit.  The
#: uncapped session has none, which gives phase 6k its time: its warm
#: answer is the profiled run's, held to the oracle, and its warm best and
#: idle share are not measured (None)
JSON_WARM_RUNS = {"uncapped": 0, "capped": 1}


def run_json_path(torch, path: str):
    """Phase 6g-b: the five JSONBench queries over the events in two
    fresh sessions: uncapped, and capped at `JSON_CAP_FRACTION` of the
    event column's arrow bytes.  Each query: a first run, the warm runs
    of `JSON_WARM_RUNS` (its warm best and idle share; None without
    one) and one profiled warm run.  The first, last and profiled runs'
    answers equal the `json` + `Counter` oracle; in the capped session
    `memory_used <= cap` after every run, variant blocks are squeezed and
    the warm runs read shredded paths with no IO (`squeeze_io_saved`)."""
    import tempfile
    import pyarrow.parquet as pq
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench import json_bench
    events = pq.read_table(path)
    want = json_bench.answers(events)
    col_bytes = events.column("event").nbytes
    n_events = events.num_rows
    del events
    cap = int(col_bytes * JSON_CAP_FRACTION)
    report = {"events": n_events, "column_bytes": col_bytes, "cap": cap}
    log(f"[json] {json.dumps(report)}")
    for mode, mem in (("uncapped", 16 << 30), ("capped", cap)):
        with tempfile.TemporaryDirectory() as d:
            ctx, cache = (LiquidCacheLocalBuilder().with_max_memory_bytes(mem)
                          .with_cache_dir(d).build())
            ctx.register_parquet("events", path)
            rows, warm_saved = {}, 0
            t_mode = time.perf_counter()
            for i, sql in enumerate(json_bench.QUERIES):
                saved = []

                def after(run):
                    if cache.stats()["memory_used"] > mem:
                        raise AssertionError(f"6g-b {mode} q{i}: memory "
                                             f"over the cap {mem}")
                    saved.append(cache.observer.stats.get(
                        "squeeze_io_saved"))

                outs, first_s, warm_ms, k1_runs = _query_runs(
                    torch, ctx, sql, JSON_WARM_RUNS[mode], after=after)
                bd = device_breakdown(torch, ctx, sql, 1.0, settle=False,
                                      answer=True)
                after(None)
                runs = (("first", outs[0]),) + (
                    (("last", outs[1]),) if warm_ms else ()) + (
                    ("profiled", bd.pop("answer")),)
                for what, got in runs:
                    if not json_bench.same_rows(got, want[i], i in (0, 1)):
                        raise AssertionError(
                            f"6g-b {mode} q{i} ({what} run): port "
                            f"{got.to_pylist()[:3]} != oracle {want[i][:3]}")
                best = min(warm_ms) if warm_ms else None
                st = cache.stats()
                row = dict(first_run_s=first_s, warm_best_ms=best,
                           warm_ms=warm_ms,
                           profiled_wall_ms=bd["profiled_wall_ms"],
                           device_busy_ms=bd["device_busy_ms"],
                           idle_share=(None if best is None else
                                       1 - bd["device_busy_ms"] / best),
                           device_ops=bd["device_ops"], k1_per_run=k1_runs,
                           warm_squeeze_io_saved=saved[-1] - saved[0],
                           stats={k: st.get(k, 0) for k in _COUNTERS},
                           by_state=st["by_state"])
                warm_saved += saved[-1] - saved[0]
                rows[f"json_q{i}"] = row
                log(f"[json] {mode} q{i}: {json.dumps(rows[f'json_q{i}'])}")
            st = cache.stats()
            summary = dict(seconds=time.perf_counter() - t_mode,
                           warm_squeeze_io_saved=warm_saved,
                           by_state=st["by_state"],
                           **{k: st.get(k, 0) for k in _COUNTERS})
            log(f"[json] {mode} summary: {json.dumps(summary)}")
            del ctx, cache
        if mode == "capped" and (summary["squeezes"] <= 0
                                 or summary["disk_writes"] <= 0
                                 or warm_saved < JSON_MIN_SHREDDED):
            raise AssertionError(f"6g-b capped: no squeeze, no disk write or "
                                 f"fewer than {JSON_MIN_SHREDDED} shredded "
                                 f"reads: {summary}")
        report[mode] = {"queries": rows, "summary": summary}
    return report


def run_pruning_path(torch, path: str):
    """Phase 6g-c: ClickBench q19 (a UserID absent from the file and
    inside its min/max) over the hits copy with bloom filters, read
    through `StoreFile(ByteCache(LocalStore(dir), cache_dir))` as the
    reference's Flight service wires a registered store.  The answer
    equals pyarrow's (no row), the first run's `bloom_prunes` equals the
    row-group count, and the bytes fetched through the byte cache are a
    small fraction of the file."""
    import tempfile
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.common.object_store import (
        ByteCache, LocalStore, StoreFile)
    sql = slice_sql(19)
    user = 435090932899640449
    from liquid_tpu_torch.io.bloom import BloomReader
    md = pq.ParquetFile(path).metadata
    ci = md.schema.to_arrow_schema().get_field_index("UserID")
    if any(BloomReader(path, md).location(rg, ci) is None
           for rg in range(md.num_row_groups)):
        raise AssertionError("phase 6g-c: the hits copy has no bloom filter")
    ids = pq.read_table(path, columns=["UserID"])["UserID"]
    mm = pc.min_max(ids)
    expect = [ids.filter(pc.equal(ids, user)).combine_chunks()]
    if not (mm["min"].as_py() <= user <= mm["max"].as_py()) or len(expect[0]):
        raise AssertionError(f"6g-c: {user} must be absent and inside "
                             f"[{mm['min']}, {mm['max']}]")
    del ids
    size = os.path.getsize(path)
    name = os.path.basename(path)
    with tempfile.TemporaryDirectory() as d:
        store = ByteCache(LocalStore(os.path.dirname(path)), d)
        ctx, cache = LiquidCacheLocalBuilder().build()
        ctx.register_parquet("hits", path,
                             open_file=lambda: StoreFile(store, name))
        table = ctx._tables["hits"]
        prunes = []
        outs, first_s, warm_ms, k1_runs = _query_runs(
            torch, ctx, sql, after=lambda run: prunes.append(
                table.bloom_prunes))
        for what, got in zip(("first", "last warm"), outs):
            if not oracle.same_table(got, expect):
                raise AssertionError(f"6g-c ({what} run): port "
                                     f"{got.to_pylist()[:3]} != pyarrow")
        if prunes[0] != md.num_row_groups:
            raise AssertionError(f"6g-c: the first run's bloom prunes "
                                 f"{prunes[0]} != {md.num_row_groups} row "
                                 f"groups")
        fetched = store.disk_usage()
        row = _row(torch, ctx, sql, first_s, warm_ms, k1_runs)
        row.update(row_groups=md.num_row_groups, bloom_prunes_per_run=[
            b - a for a, b in zip([0] + prunes, prunes)],
                   file_bytes=size, fetched_bytes=fetched,
                   fetched_share=fetched / size,
                   byte_cache_blocks=store.cached_blocks(name),
                   answer_rows=outs[1].num_rows)
        del ctx, cache
    log(f"[pruning] cb_q19: {json.dumps(row)}")
    if fetched * 4 > size:
        raise AssertionError(f"6g-c: fetched {fetched} of {size} bytes")
    return {"cb_q19_bloom": row}


# -- phase 6h: windows and grouping sets over TPC-DS ----------------------------

#: the TPC-DS tables phase 6h's queries read
TPCDS_TABLES = ("store_sales", "web_sales", "item", "date_dim", "store",
                "customer_demographics",
                # phase 6i's TPC-DS queries besides
                "catalog_sales", "promotion", "household_demographics",
                "customer_address", "inventory", "time_dim")
#: phase 6h's warm runs per query (beside its first and profiled runs)
TPCDS_WARM_RUNS = 1


def prepare_tpcds(data_dir: str, sf: float) -> dict:
    """Phase 6h's TPC-DS tables at scale `sf` from one
    `tpcds_data.generate(sf)` as parquet, each written once -> {table:
    path}."""
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench import tpcds_data
    os.makedirs(data_dir, exist_ok=True)
    paths = {t: os.path.join(data_dir, f"liquid_tpcds_{t}_{sf}.parquet")
             for t in TPCDS_TABLES}
    missing = [t for t, p in paths.items() if not os.path.exists(p)]
    if missing:
        made = tpcds_data.generate(sf)
        for t in missing:
            pq.write_table(made[t], paths[t] + ".tmp", row_group_size=1 << 20)
            os.replace(paths[t] + ".tmp", paths[t])
    return paths


def run_tpcds_path(torch, dspaths: dict, expect: dict) -> dict:
    """Phase 6h: TPC-DS q98 (`sum(sum(x)) OVER (PARTITION BY i_class)` over
    a star join), q27 (ROLLUP with `grouping()` over a five-table join),
    q86 (`rank() OVER` a ROLLUP, partitioned by `grouping()` sums) and q51
    (running sums in a ROWS frame, a full outer join and a running max)
    as `bench/tpcds_queries.py` gives them, in one fresh session on the
    card -> report.  Each query: a first run and `TPCDS_WARM_RUNS` warm
    runs, both answers equal to pyarrow (`bench/oracle.py`, the tie rule
    of a LIMIT cut), one profiled run (device busy, idle share); the
    executor's hand-offs (`exec.STATS`) and K1 launches per run logged.
    The inner queries run through the engine's routes on the card; the
    windows run on the host over their results."""
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench import oracle, tpcds_queries
    from liquid_tpu_torch.sql import exec as texec
    from liquid_tpu_torch.sql import fused_agg
    ctx, cache = LiquidCacheLocalBuilder().with_max_memory_bytes(
        16 << 30).build()
    for name, p in dspaths.items():
        ctx.register_parquet(name, p)
    report = {}
    for qid in oracle.TPCDS_QUERIES:
        name, sql = f"ds_q{qid}", tpcds_queries.QUERIES[qid]
        e0 = dict(texec.STATS)
        f0 = {k: fused_agg.STATS[k] for k in ("fused_queries",
                                               "star_queries")}
        outs, first_s, warm_ms, k1_runs = _query_runs(
            torch, ctx, sql, warm_runs=TPCDS_WARM_RUNS)
        for what, got in zip(("first", "last warm"), outs):
            if not oracle.same_table(got, expect[name], oracle.CUTS[name]):
                raise AssertionError(
                    f"6h {name} ({what} run): port {got.to_pylist()[:3]} "
                    f"!= pyarrow {[c.to_pylist()[:3] for c in expect[name]]}")
        bd = device_breakdown(torch, ctx, sql, min(warm_ms), settle=False)
        report[name] = dict(
            first_run_s=first_s, warm_best_ms=min(warm_ms), warm_ms=warm_ms,
            device_busy_ms=bd["device_busy_ms"],
            idle_share=bd["idle_share"], device_ops=bd["device_ops"],
            k1_per_run=k1_runs, rows=outs[1].num_rows,
            exec_stats={k: v - e0[k] for k, v in texec.STATS.items()
                        if v != e0[k]},
            fused_stats={k: fused_agg.STATS[k] - v for k, v in f0.items()})
        log(f"[tpcds] {name}: {json.dumps(report[name])}")
    del ctx, cache
    return report


# -- phase 6i: multi-device execution on a mesh of shards on the card ---------

#: shards of phase 6i's mesh, all on the one card
DIST_SHARDS = 4
#: phase 6i's warm runs per query of each set, beside its first run
DIST_WARM_RUNS = {"tpch": 1, "clickbench": 1, "tpcds": 1}


def dist_queries() -> list:
    """Phase 6i's queries: (set, name, SQL or statement list, oracle key of
    `expect` or None for TPC-DS, held to the single-device session)."""
    from liquid_tpu_torch.bench import oracle, tpcds_queries, tpch_queries
    from liquid_tpu_torch.parallel.session import DIST_TPCDS_SUPPORTED
    here = os.path.dirname(os.path.abspath(__file__))
    out = [("tpch", f"tpch_q{q}", tpch_queries.QUERIES[q], key)
           for q, key in oracle.DIST_TPCH.items()]
    for q, key in oracle.DIST_CB.items():
        with open(os.path.join(here, "benchmark", "clickbench", "queries",
                               f"q{q}.sql")) as f:
            out.append(("clickbench", f"cb_q{q}",
                        f.read().strip().rstrip(";"), key))
    out += [("tpcds", f"ds_q{q}", tpcds_queries.QUERIES[q], None)
            for q in DIST_TPCDS_SUPPORTED]
    return out


def dist_columns(table_paths: dict, queries: list) -> dict:
    """{table: the columns of its schema that the queries' texts name}."""
    import re
    import pyarrow.parquet as pq
    words = set()
    for _set, _name, sql, _key in queries:
        for text in (sql if isinstance(sql, list) else [sql]):
            words |= set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", text))
    return {t: [c for c in pq.read_schema(p).names if c in words]
            for t, p in table_paths.items()}


def dist_tpcds_expect(torch, dspaths: dict, device="cuda") -> dict:
    """The single-device session's answers to phase 6i's TPC-DS queries on
    the same files and card (the phase's oracle for that set)."""
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    ctx, cache = LiquidCacheLocalBuilder(device).with_max_memory_bytes(
        16 << 30).build()
    for name, p in dspaths.items():
        ctx.register_parquet(name, p)
    out = {}
    for _set, name, sql, key in dist_queries():
        if key is None:
            got = ctx.sql(sql).to_arrow()
            torch.cuda.synchronize()
            out[name] = got.columns
    del ctx, cache
    return out


#: phase 6i's queries whose first shard's fused selections phase 10 times
DIST_SELECT_SETS = ("tpch_q6", "ds_q37")
#: phase 6i's queries profiled in one more warm run (device busy, idle)
DIST_PROFILED = ("ds_q37", "ds_q82")


def run_dist_path(torch, paths: dict, dspaths: dict, expect: dict,
                  ds_expect: dict, device="cuda:0"):
    """Phase 6i (module doc), its shards on `device` -> (report, summary,
    one shard's l_shipdate planes, {query: the first shard's (sel,
    predicates) of its largest scan} for `DIST_SELECT_SETS`)."""
    import types
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.ops import bitpack_cuda as k
    from liquid_tpu_torch.parallel import dist, make_mesh
    from liquid_tpu_torch.parallel.session import DistributedSession
    queries = dist_queries()
    select = k.select_planes
    calls = []  # (sel, predicates) of every fused selection

    def counted(sel, preds):
        calls.append((sel, preds))
        return select(sel, preds)

    k.select_planes = counted
    try:
        mesh = make_mesh(devices=[device] * DIST_SHARDS)
        sess = DistributedSession(mesh)
        t0 = time.perf_counter()
        tables = {**paths, **dspaths}  # TPC-H, hits and TPC-DS
        cols = dist_columns(tables, queries)
        for t, names in cols.items():
            if names:
                sess.register_parquet(t, tables[t], names)
        torch.cuda.synchronize()
        log(f"[dist] mesh {mesh}; tables registered with the columns their "
            f"queries name in {time.perf_counter() - t0:.1f} s: "
            f"{json.dumps({t: c for t, c in cols.items() if c})}")
        report, planned, launched, predicates, sets = {}, 0, 0, 0, {}
        for qset, name, sql, key in queries:
            want = expect[key] if key is not None else ds_expect[name]
            cut = oracle.CUTS.get(key) if key is not None else None
            times, k4_runs, plan_runs, pred_runs = [], [], [], []
            for run in range(1 + DIST_WARM_RUNS[qset]):
                routed0 = dict(sess.route_stats)
                calls.clear()
                k40 = k.LAUNCHES["cmp_const_planes"]
                t1 = time.perf_counter()
                got = sess.sql(sql)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                k4_runs.append(k.LAUNCHES["cmp_const_planes"] - k40)
                plan_runs.append(dist.DIAG["k4_planned"])
                # the single form's count: a launch per shard per predicate
                pred_runs.append(sum(len(p) for _s, p in calls))
                if run == 0 and name in DIST_SELECT_SETS:
                    # the first shard's selection of each scan (a scan's
                    # shards come in order), the most plane bytes kept
                    sets[name] = max(calls[::DIST_SHARDS],
                                     key=lambda sp: sum(
                                         p.numel() for p, *_r in sp[1]))
                stmts = len(sql) if isinstance(sql, list) else 1
                if sess.route_stats["fallback"] != routed0["fallback"] or \
                        sess.route_stats["distributed"] \
                        != routed0["distributed"] + stmts:
                    raise AssertionError(
                        f"6i {name} run {run} took the single-device route: "
                        f"{sess.route_stats['fallback_reasons'][-1:]}")
                if dist.DIAG["exchange_overflow"]:
                    raise AssertionError(f"6i {name}: exchange overflow "
                                         f"{dist.DIAG['exchange_overflow']}")
                if not oracle.same_table(got, want, cut):
                    raise AssertionError(
                        f"6i {name} (run {run}): mesh "
                        f"{got.to_pylist()[:3]} != oracle "
                        f"{[c.to_pylist()[:3] for c in want]}")
            if k4_runs != plan_runs:
                raise AssertionError(f"6i {name}: K4 launches {k4_runs} per "
                                     f"run != the plans' {plan_runs}")
            planned += sum(plan_runs)
            launched += sum(k4_runs)
            predicates += sum(pred_runs)
            diag = {d: dist.DIAG[d] for d in (
                "collectives", "collective_bytes", "exchanges",
                "exchange_rows", "exchange_bytes", "exchange_balance")}
            report[name] = dict(
                set=qset, first_run_s=times[0],
                warm_ms=[t * 1e3 for t in times[1:]], k4_per_run=k4_runs,
                k4_predicates_per_run=pred_runs,
                scan_bytes=sess.last_scan_bytes, rows=got.num_rows, **diag)
            if name in DIST_PROFILED:
                # device_breakdown's session: .sql(...).to_arrow()
                ctx = types.SimpleNamespace(
                    sql=lambda q: types.SimpleNamespace(
                        to_arrow=lambda: sess.sql(q)))
                k40 = k.LAUNCHES["cmp_const_planes"]
                bd = device_breakdown(torch, ctx, sql, min(report[name][
                    "warm_ms"]))
                # a settling run and the profiled one
                if k.LAUNCHES["cmp_const_planes"] - k40 != 2 * plan_runs[-1]:
                    raise AssertionError(f"6i {name}: K4 launches in the "
                                         f"profiled runs != the plans'")
                del bd["ms_by_name"]
                report[name]["profile"] = bd
            log(f"[dist] {name}: {json.dumps(report[name])}")
        # the fused form: fewer launches than one per shard per predicate
        if launched <= 0 or launched != planned or launched >= predicates:
            raise AssertionError(f"6i: K4 launches {launched}, planned "
                                 f"{planned}, bit-plane predicates over the "
                                 f"shards {predicates}")
        if set(sets) != set(DIST_SELECT_SETS):
            raise AssertionError(f"6i: no fused selection in "
                                 f"{set(DIST_SELECT_SETS) - set(sets)}")
        shard = sess.tables["lineitem"].columns["l_shipdate"].planes[0]
        summary = dict(shards=DIST_SHARDS, queries=len(report),
                       k4_launches=launched, k4_planned=planned,
                       k4_predicates=predicates,
                       route_stats={k_: v for k_, v in
                                    sess.route_stats.items()
                                    if k_ != "fallback_reasons"},
                       shard_planes=list(shard.shape))
        del sess
        return report, summary, shard, sets
    finally:
        k.select_planes = select


# -- phase 6j: the disaggregated server ----------------------------------------

#: phase 6j's queries over Flight, from `bench/main.py`'s list (`cb_like`
#: is left out: its FSST `URL` column is the costliest transcode, and
#: phase 5 holds its route)
SERVER_QUERIES = ("cb_filter", "cb_groupby", "tpch_q6", "tpch_q1", "tpch_q3")
#: phase 6j's partitioned scan: a plain scan of `hits`, one row group per
#: partition at full size
SERVER_SCAN = 'SELECT "UserID", "RegionID" FROM hits WHERE "AdvEngineID" <> 0'
SERVER_PARTITIONS = 4


def _engine_counts():
    """The engine's route counters and the kernels' launch counts."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    from liquid_tpu_torch.sql import exec as texec
    from liquid_tpu_torch.sql import fused_agg
    return {**{f"fused.{k}": v for k, v in fused_agg.STATS.items()
               if isinstance(v, int)},
            **{f"exec.{k}": v for k, v in texec.STATS.items()},
            **k1.LAUNCHES, **k2.LAUNCHES}


def _counts_since(before: dict) -> dict:
    """What moved since `before` (counters that stayed are left out)."""
    return {k: v - before[k] for k, v in _engine_counts().items()
            if v != before[k]}


def _http_json(addr, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=120) as r:
        return json.loads(r.read())


def run_server_path(torch, ctx, paths: dict, expect: dict,
                    warm_best: dict, device="cuda") -> dict:
    """Phase 6j (module doc): the Flight service and the admin server over
    the session `ctx`, whose cache must lie on `device`; `warm_best` holds
    each query's in-process warm best (ms) from the earlier phases ->
    per-query report."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench import main as bench
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.devtools import trace_viz
    from liquid_tpu_torch.server import (
        AdminServer, LiquidCacheClientBuilder, LiquidCacheService,
    )
    from liquid_tpu_torch.server import flight
    from liquid_tpu_torch.utils.tracing import TRACER
    sqls = {q[0]: q[3] for q in bench.queries(0, 0)}
    srv = LiquidCacheService(ctx.cache, host="127.0.0.1", port=0)
    srv.inner.ctx = ctx  # as `bench/clients.serve` installs its session
    want_type = torch.device(device).type
    if srv.inner.cache.device.type != want_type \
            or ctx.device.type != want_type:
        raise AssertionError(f"6j: the server's cache is on "
                             f"{srv.inner.cache.device}")
    admin = AdminServer(srv.inner, host="127.0.0.1", port=0)
    addr, aaddr = srv.start(), admin.start()
    clients = []

    def client(partitions=1):
        b = LiquidCacheClientBuilder(*addr).with_partitions(partitions)
        for name, path in paths.items():
            b = b.with_parquet_table(name, path)
        clients.append(b.build())
        return clients[-1]

    report = {}
    try:
        one = client()
        for q in SERVER_QUERIES:
            sql = sqls[q]
            for _ in range(2):  # the second is warm whatever ran before
                before = _engine_counts()
                ctx.sql(sql).to_arrow()
                torch.cuda.synchronize()
                local = _counts_since(before)
            if local.get("cmp_const_many", 0) != K1_PER_RUN[q]:
                raise AssertionError(f"6j {q}: in-process K1 {local}, "
                                     f"expected {K1_PER_RUN[q]}")
            fetches = []
            for _ in range(2):
                before = _engine_counts()
                t0 = time.perf_counter()
                out = one.sql(sql)
                torch.cuda.synchronize()
                fetches.append(((time.perf_counter() - t0) * 1e3,
                                _counts_since(before), out,
                                one.last_metrics))
            (first_ms, first, out1, m1), (again_ms, again, out2, _m2) = \
                fetches
            for what, got in (("first", out1), ("repeated", out2)):
                if not oracle.same_table(got, expect[q]):
                    raise AssertionError(f"6j {q} ({what} fetch): "
                                         f"{got.to_pylist()[:2]} != pyarrow")
            if first != local:
                raise AssertionError(f"6j {q}: the first fetch counted "
                                     f"{first}, in process {local}")
            if again:
                raise AssertionError(f"6j {q}: a repeated fetch ran the "
                                     f"engine: {again}")
            report[q] = dict(
                flight_ms=first_ms, repeated_fetch_ms=again_ms,
                in_process_warm_best_ms=warm_best[q],
                server_cost_ms=first_ms - warm_best[q],
                time_to_first_batch_ms=m1.time_to_first_batch_ms,
                rows=m1.rows, batches=m1.batches,
                k1_launches=first.get("cmp_const_many", 0),
                k2_launches=first.get("group_accumulate", 0),
                routes={k: v for k, v in first.items()
                        if k.startswith(("fused.", "exec."))})
            log(f"[server] {q}: {json.dumps(report[q])}")

        # the partitioned scan, twice; the second under the cache trace
        base = ctx._tables["hits"]
        if flight._partitionable_scan(SERVER_SCAN, ctx._tables) != "hits":
            raise AssertionError("6j: the scan is not partitionable")
        cols = ["UserID", "RegionID"]
        want = pq.read_table(paths["hits"], columns=cols + ["AdvEngineID"])
        want = want.filter(pc.not_equal(want["AdvEngineID"], 0)).select(
            cols).sort_by([(c, "ascending") for c in cols])
        if want.num_rows != expect["cb_filter"][0][0].as_py():
            raise AssertionError("6j: pyarrow's scan != cb_filter's count")
        split = [srv.inner._partition_rgs(base, p, SERVER_PARTITIONS)
                 for p in range(SERVER_PARTITIONS)]
        if sorted(rg for rgs in split for rg in rgs) != list(
                range(base.num_row_groups)):
            raise AssertionError(f"6j: partitions {split}")
        executed = []
        slice_of = srv.inner._execute_slice

        def watched(sql, name, tbl, rgs):
            executed.append(list(rgs))
            return slice_of(sql, name, tbl, rgs)

        srv.inner._execute_slice = watched
        four = client(SERVER_PARTITIONS)
        try:
            for run in ("first", "second"):
                if run == "second":
                    _http_json(aaddr, "/start_trace")
                executed.clear()
                before = _engine_counts()
                t0 = time.perf_counter()
                out = four.sql(SERVER_SCAN)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                moved = _counts_since(before)
                m = four.last_metrics
                if sorted(executed) != sorted(split):
                    raise AssertionError(f"6j scan: executed {executed}, "
                                         f"partitions {split}")
                got = out.select(cols)
                types = [str(f.type) for f in got.schema]
                got = got.cast(want.schema).sort_by(
                    [(c, "ascending") for c in cols])
                if not got.equals(want):
                    raise AssertionError(f"6j scan ({run} run): "
                                         f"{got.num_rows} rows != pyarrow's "
                                         f"{want.num_rows}")
                if moved.get("cmp_const_many", 0) <= 0:
                    raise AssertionError(f"6j scan ({run} run) did not "
                                         f"launch K1: {moved}")
                report[f"scan_{run}"] = dict(
                    flight_ms=ms,
                    time_to_first_batch_ms=m.time_to_first_batch_ms,
                    total_stream_ms=m.total_stream_ms, rows=m.rows,
                    batches=m.batches, types=types,
                    partitions=split, k1_launches=moved["cmp_const_many"],
                    routes={k: v for k, v in moved.items()
                            if k.startswith(("fused.", "exec."))})
                log(f"[server] scan ({run} run): "
                    f"{json.dumps(report[f'scan_{run}'])}")
        finally:
            srv.inner._execute_slice = slice_of

        # the admin routes
        stats = _http_json(aaddr, "/cache_stats")
        info = _http_json(aaddr, "/cache_info")
        plans = _http_json(aaddr, "/execution_plans")
        if stats["entries"] <= 0 or info["memory_usage_bytes"] <= 0:
            raise AssertionError(f"6j: admin {stats} {info}")
        asked = {sqls[q] for q in SERVER_QUERIES} | {SERVER_SCAN}
        if {p["sql"] for p in plans.values()} != asked \
                or not all(p["executed"] for p in plans.values()):
            raise AssertionError(f"6j: execution plans {plans}")
        for h in plans:
            met = _http_json(aaddr, f"/execution_metrics?handle={h}")
            if set(met) != {"pushdown_eval_time", "cache_memory_usage",
                            "liquid_cache_usage"} \
                    or met["cache_memory_usage"] <= 0:
                raise AssertionError(f"6j: execution metrics {met}")
        trace_path = os.path.join(tempfile.gettempdir(),
                                  "liquid_tpu_torch_6j_trace.parquet")
        flushed = _http_json(aaddr, f"/stop_trace?path={trace_path}")
        records = trace_viz.load_trace(trace_path)
        html = trace_viz.render_html(records, title=trace_path)
        if flushed["flushed"] <= 0 or len(records) != flushed["flushed"] \
                or f"{len(records)} events" not in html:
            raise AssertionError(f"6j: trace {flushed}, {len(records)} "
                                 f"records rendered")
        report["admin"] = dict(
            entries=stats["entries"], memory_usage_bytes=info[
                "memory_usage_bytes"], plans=len(plans),
            trace_records=len(records), trace_html_bytes=len(html),
            trace_ops=sorted({r[1] for r in records}))

        # the client's trace continued by the server's span
        TRACER.reset()
        TRACER.enable()
        try:
            one.sql(sqls["tpch_q6"])
        finally:
            TRACER.disable()
        spans = TRACER.spans()
        TRACER.reset()
        csql = [s for s in spans if s.name == "client.sql"]
        fetch = [s for s in spans if s.name == "server.fetch"]
        if len(csql) != 1 or len(fetch) != 1 \
                or fetch[0].trace_id != csql[0].trace_id \
                or fetch[0].parent_id != csql[0].span_id:
            raise AssertionError(f"6j: the trace did not propagate: "
                                 f"{[(s.name, s.trace_id, s.parent_id) for s in spans]}")

        log(f"[server] admin {json.dumps(report['admin'])}")
    finally:
        for c in clients:
            c.close()
        try:
            admin.stop()
        finally:
            srv.stop()
    report["after_reset"] = server_reset_check(torch, paths["hits"],
                                               sqls["cb_filter"],
                                               expect["cb_filter"], device)
    log(f"[server] after /reset_cache {json.dumps(report['after_reset'])}")
    return report


def server_reset_check(torch, hits: str, sql: str, want, device) -> dict:
    """Phase 6j's `/reset_cache`: on a service and admin server of their
    own over a fresh session of `hits` (a reset of the main session's
    cache would make phase 9 transcode every column again): `sql`
    answered, the cache and plans emptied by the admin route, `sql`
    answered again from the file by the same client, both equal to
    `want`; the client's stale handle costs it exactly one registration
    more -> timings and registrations."""
    from liquid_tpu_torch import LiquidCacheLocalBuilder
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.server import (
        AdminServer, LiquidCacheClientBuilder, LiquidCacheService,
    )
    ctx, cache = LiquidCacheLocalBuilder(device=device).build()
    srv = LiquidCacheService(cache, host="127.0.0.1", port=0)
    srv.inner.ctx = ctx
    admin = AdminServer(srv.inner, host="127.0.0.1", port=0)
    addr, aaddr = srv.start(), admin.start()
    out = {}
    client = (LiquidCacheClientBuilder(*addr)
              .with_parquet_table("hits", hits).build())
    try:
        for when in ("before", "after"):
            t0 = time.perf_counter()
            got = client.sql(sql)
            out[f"{when}_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"registrations_{when}"] = client.registrations
            if not oracle.same_table(got, want):
                raise AssertionError(f"6j: {got.to_pylist()} != pyarrow "
                                     f"{when} /reset_cache")
            if when == "before":
                out["entries_before"] = _http_json(
                    aaddr, "/cache_stats")["entries"]
                _http_json(aaddr, "/reset_cache")
                if _http_json(aaddr, "/cache_stats")["entries"] != 0 \
                        or srv.inner.plans:
                    raise AssertionError("6j: /reset_cache left entries "
                                         "or plans")
        if (out["registrations_before"], out["registrations_after"]) != (1, 2):
            raise AssertionError(f"6j: the client did not re-register "
                                 f"exactly once after /reset_cache: {out}")
    finally:
        client.close()
        try:
            admin.stop()
        finally:
            srv.stop()
    return out


# -- phase 6k: the rest of the harness ----------------------------------------

#: phase 6k-b's StackOverflow size: ten times the generator's default, so
#: a posts column spans ~25 blocks of 8,192 rows and the 10 MB cap must
#: squeeze and spill
SO_USERS, SO_POSTS = 20_000, 200_000
#: the reference CI's memory cap for the StackOverflow-DBA suite
SO_CAP = 10 << 20
#: phase 6k-b's sessions: (label, mode, cap in bytes or None)
SO_SESSIONS = (("liquid_10mb", "liquid", SO_CAP),
               ("arrow_10mb", "arrow", SO_CAP),
               ("liquid_uncapped", "liquid", None))
#: phase 6k-d ends its fuzz seeds this many seconds after it started
FUZZ_SECONDS = 15.0
#: phase 6k-e: the runnable examples (the server serves until shut down)
EXAMPLES = ("example_local", "example_inprocess_read",
            "example_inprocess_insertion",
            "example_inprocess_cache_eviction", "example_client",
            "example_projection_pushdown")


def prepare_stackoverflow(data_dir: str, users: int, posts: int) -> dict:
    """Phase 6k-b's five tables, written once into a directory of their
    own -> {table: path}."""
    import shutil
    from liquid_tpu_torch.bench import stackoverflow_data as so
    out = os.path.join(data_dir, f"so_{users}_{posts}")
    paths = {n: os.path.join(out, f"{n}.parquet") for n in
             ("users", "posts", "comments", "votes", "badges")}
    if not all(os.path.exists(p) for p in paths.values()):
        tmp = out + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        so.write_parquet(so.generate(users, posts), tmp)
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
    return paths


def _finite_fields(r: dict) -> bool:
    import math
    nums = [v for v in r.values() if isinstance(v, (int, float))
            and not isinstance(v, bool)]
    nums += [v for v in r.get("per_point", [])]
    return all(math.isfinite(v) and v >= 0 for v in nums)


def run_micro_path(torch, dev) -> dict:
    """Phase 6k-a -> {name: result}."""
    import numpy as np
    from liquid_tpu_torch.arrays.base import Predicate
    from liquid_tpu_torch.bench import micro
    from liquid_tpu_torch.device import words_to_numpy
    from liquid_tpu_torch.ops import bitpack as bp
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    out = {}
    for name, fn in micro.REGISTRY.items():
        before = k1.LAUNCHES["cmp_const_many"]
        t0 = time.perf_counter()
        r = fn(False, dev)
        r["k1_launches"] = k1.LAUNCHES["cmp_const_many"] - before
        r["phase_s"] = time.perf_counter() - t0
        log(f"[micro] {json.dumps(r)}")
        if not _finite_fields(r):
            raise AssertionError(f"phase 6k-a: {name} reported a value "
                                 f"that is not finite and >= 0: {r}")
        out[name] = r
    for name in ("fsst_view", "primitive_encoding"):
        if not out[name]["ratio"] < 1:
            raise AssertionError(f"phase 6k-a: {name} does not compress: "
                                 f"{out[name]}")
    ev = out["eviction"]
    if ev["squeezes"] + ev["disk_evictions"] <= 0:
        raise AssertionError(f"phase 6k-a: no squeeze and no disk write "
                             f"under pressure: {ev}")
    planes = micro.bitpacking_input(False, dev)
    got = bp.unpack_bitplanes(planes).cpu().numpy().view(np.uint64)
    if not np.array_equal(got, bp.unpack_bitplanes_host(
            words_to_numpy(planes))):
        raise AssertionError("phase 6k-a: bitpacking's unpack on the card "
                             "differs from unpack_bitplanes_host")
    cache, ids = micro.filter_pushdown_cache(False, dev)
    fp = out["filter_pushdown"]
    want = fp["evals"] * k1_groups(cache, ids, Predicate(*micro.FILTER_PRED))
    if want <= 0 or fp["k1_launches"] != want:
        raise AssertionError(f"phase 6k-a: filter_pushdown launched K1 "
                             f"{fp['k1_launches']} times, its buckets "
                             f"predict {want}")
    return out


def run_stackoverflow_path(torch, sopaths: dict, expect: dict,
                           cache_dir: str, dev) -> dict:
    """Phase 6k-b -> {session: {query: row, "stats": cache stats}}."""
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.bench import stackoverflow_data as so
    from liquid_tpu_torch.bench.runner import make_session
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    report = {}
    for label, mode, cap in SO_SESSIONS:
        ctx, cache = make_session(mode, cap or 1 << 40,
                                  os.path.join(cache_dir, f"so_{label}"),
                                  dev)
        if cache.device != dev:
            raise AssertionError(f"phase 6k-b: {label} on {cache.device}")
        for name, path in sopaths.items():
            ctx.register_parquet(name, path)
        rows = {}
        for qi, sql in enumerate(so.QUERIES):
            runs = []
            for _run in range(2):
                l1 = k1.LAUNCHES["cmp_const_many"]
                l2 = k2.LAUNCHES["group_accumulate"]
                t0 = time.perf_counter()
                out = ctx.sql(sql).to_arrow()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if not oracle.same_table(out, expect[f"so_q{qi}"]):
                    raise AssertionError(f"phase 6k-b: {label} q{qi} != "
                                         f"pyarrow: {out.slice(0, 5)}")
                used = cache.stats()["memory_used"]
                if cap is not None and used > cap:
                    raise AssertionError(f"phase 6k-b: {label} q{qi} holds "
                                         f"{used} bytes over its cap {cap}")
                runs.append({"ms": ms,
                             "k1": k1.LAUNCHES["cmp_const_many"] - l1,
                             "k2": k2.LAUNCHES["group_accumulate"] - l2})
            rows[f"so_q{qi}"] = {"first_ms": runs[0]["ms"],
                                 "warm_ms": runs[1]["ms"],
                                 "k1": [r["k1"] for r in runs],
                                 "k2": [r["k2"] for r in runs]}
            log(f"[so] {label} q{qi}: {json.dumps(rows[f'so_q{qi}'])}")
        st = cache.stats()
        stats = {k: st.get(k, 0) for k in _COUNTERS}
        if cap is not None and stats["squeezes"] + stats["disk_writes"] <= 0:
            raise AssertionError(f"phase 6k-b: {label} neither squeezed nor "
                                 f"spilled under {cap} bytes: {stats}")
        log(f"[so] {label}: {json.dumps(stats)} {json.dumps(st['by_state'])}")
        report[label] = {**rows, "stats": stats, "by_state": st["by_state"]}
    return report


def run_schedule_path(torch, tmp_dir: str, dev) -> dict:
    """Phase 6k-c -> counts of schedules explored and the replay's."""
    from liquid_tpu_torch.bench import schedules
    from liquid_tpu_torch.utils import shuttle
    n = schedules.ITERATIONS
    budget = schedules.budget_workload()
    shuttle.check(budget, iterations=n["budget"])
    if budget.budget.memory_used != 0:
        raise AssertionError(f"phase 6k-c: the budget nets to "
                             f"{budget.budget.memory_used}")
    inserts = schedules.insert_workload(dev, tmp_dir)
    shuttle.check(inserts, iterations=n["insert"])
    if inserts.cache.device != dev:
        raise AssertionError(f"phase 6k-c: cache on {inserts.cache.device}")
    schedules.check_inserts(inserts.cache)
    shuttle.check(schedules.advice_workload(), iterations=n["advice"])
    trace = shuttle.Scheduler(seed=n["insert"]).run_workload(inserts)
    states = schedules.check_inserts(inserts.cache)
    again = shuttle.replay(inserts, trace)
    if again != trace or schedules.check_inserts(inserts.cache) != states:
        raise AssertionError(f"phase 6k-c: replay diverged: {trace} -> "
                             f"{again}")
    return {**n, "replay_steps": len(trace), "entries": states}


def run_fuzz_path(torch, dev, seconds: float) -> dict:
    """Phase 6k-d -> cases checked; a divergence raises with its seed."""
    from liquid_tpu_torch.bench import fuzz
    t0 = time.perf_counter()
    for seed in range(60):
        fuzz.check_case(seed, dev)
    for seed in range(40):
        fuzz.check_primitive_case(seed, dev)
    fixed_s = time.perf_counter() - t0
    seed = 1_000_000
    while time.perf_counter() - t0 < seconds:
        fuzz.check_case(seed, dev)
        fuzz.check_primitive_case(seed, dev)
        seed += 1
    return {"fixed_cases": 100, "fixed_s": fixed_s,
            "new_seeds": seed - 1_000_000,
            "seconds": time.perf_counter() - t0}


def run_examples_path(torch, dev) -> dict:
    """Phase 6k-e -> seconds per example."""
    import importlib.util
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch")
    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", os.path.join(here, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main(["--device", dev.type])
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    return out


def run_suites_path(torch, sopaths: dict, expect: dict, tmp_dir: str,
                    device="cuda:0") -> dict:
    """Phase 6k, its parts a-e in order on `device` -> {part: report,
    "s": seconds}."""
    dev = torch.device(device)
    os.makedirs(tmp_dir, exist_ok=True)
    report, secs = {}, {}
    for part, run in (
            ("micro", lambda: run_micro_path(torch, dev)),
            ("stackoverflow", lambda: run_stackoverflow_path(
                torch, sopaths, expect, tmp_dir, dev)),
            ("schedules", lambda: run_schedule_path(torch, tmp_dir, dev)),
            ("fuzz", lambda: run_fuzz_path(torch, dev, FUZZ_SECONDS)),
            ("examples", lambda: run_examples_path(torch, dev))):
        t0 = time.perf_counter()
        report[part] = run()
        secs[part] = time.perf_counter() - t0
        if part in ("schedules", "fuzz", "examples"):
            log(f"[suites] {part}: {json.dumps(report[part], default=str)}")
        log(f"[suites] {part} {secs[part]:.1f} s")
    report["s"] = secs
    return report


def time_k1_narrow(torch, inputs: list) -> dict:
    """Phase 7, the pressure phase's inputs: every (planes, cs) phase 6f
    gave K1's single form checked bit-exact against `cmp_const_many_ref`
    (stacked by width: each block's result depends on its own planes and
    constant alone), and the largest narrow one (a squeezed array's
    compare) timed beside its plain version and its byte bound."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    if not inputs:
        raise AssertionError("phase 6f left no K1 single-form inputs")
    by_width = {}
    for planes, cs, _label in inputs:
        by_width.setdefault(planes.shape[1], []).append((planes, cs))
    worst = 0
    for group in by_width.values():
        for i in range(0, len(group), 4096):
            part = group[i:i + 4096]
            planes = torch.cat([p for p, _ in part])
            cs = torch.cat([c for _, c in part])
            worst = max(worst, _max_abs_err(
                torch, k1.cmp_const_many(planes, cs),
                k1.cmp_const_many_ref(planes, cs)))
    if worst:
        raise AssertionError(f"K1's single form != plain on phase 6f's "
                             f"inputs: {worst}")
    narrow = [x for x in inputs if x[2] == "narrow"]
    planes, cs, label = max(narrow or inputs, key=lambda x: x[0].numel())
    bsz, width, _ = planes.shape
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    t_bytes = k1_single_bytes(bsz, width) / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * width * bsz * 256 / WORD_OPS_PER_S * 1e3
    row = dict(inputs=len(inputs), narrow_inputs=len(narrow),
               widths={int(w): len(g) for w, g in sorted(by_width.items())},
               label=label or "resident", B=bsz, w=width,
               bytes=k1_single_bytes(bsz, width),
               ms=time_cold(torch, lambda: k1.cmp_const_many(planes, cs),
                            flush, 100),
               plain_ms=time_cold(torch, lambda: k1.cmp_const_many_ref(
                   planes, cs), flush, 20),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=worst)
    log(f"[k1-narrow] {json.dumps(row)}")
    return row


def k1_single_bytes(bsz: int, width: int) -> int:
    """Bytes K1's single form must move: planes and the constants read
    once, both masks written."""
    return bsz * width * 256 * 4 + bsz * 8 + 2 * bsz * 256 * 4


def time_k1_single(torch, inputs: list, phase: str = "6e") -> dict:
    """Phase 7, the single form: every (planes, cs) the phase gave K1
    checked bit-exact against `cmp_const_many_ref`, and the largest timed
    (timer B, L2 flushed) beside its plain version and its byte bound."""
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    if not inputs:
        raise AssertionError(f"phase {phase} left no K1 single-form inputs")
    worst = 0
    for planes, cs, _label in inputs:
        worst = max(worst, _max_abs_err(torch, k1.cmp_const_many(planes, cs),
                                        k1.cmp_const_many_ref(planes, cs)))
    if worst:
        raise AssertionError(f"K1's single form != plain on phase "
                             f"{phase}'s inputs: {worst}")
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
    log(f"[k1-single] phase {phase}: {json.dumps(row)}")
    return row


def main_path_k1_inputs(ctx):
    """(planes, lo, hi, query table) for every interval the main path's
    cached plans fed to K1."""
    from liquid_tpu_torch.sql import fused_agg
    out = []
    for name, table in ctx._tables.items():
        for hit in fused_agg.table_state(table).plans.values():
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


def device_breakdown(torch, ctx, sql: str, warm_best_ms: float,
                     settle: bool = True, answer: bool = False) -> dict:
    """Phase 9: one warm run of `sql` under torch.profiler -> device-busy
    ms (union of kernel and copy intervals), the idle share of the
    unprofiled best warm time, the device operation count and the
    device operations that took longest.  The profiler slows the host,
    so its own wall time is reported but not used for the idle share.
    One unprofiled run first: a cache insert since the query's own warm
    runs (a later phase transcoding its columns) makes its next run plan
    and upload again; `settle=False` skips it (phase 6f calls this right
    after the query's warm runs); `answer=True` returns the profiled
    run's answer under "answer", for its caller to check.  The device
    events are read from the
    profiler's raw kineto list: `prof.events()` builds the whole CPU
    event tree in Python, seconds for a query of thousands of
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if settle:
        run_statements(ctx, sql)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_statements(ctx, sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not e.is_hidden_event()]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _n, s, e in dev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for name, s, e in dev:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e - s, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    cats = sorted(((n, v) for n, v in by_name.items() if "Cat" in n),
                  key=lambda kv: -kv[1][0])
    return dict(
        **({"answer": out} if answer else {}),
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
    ap.add_argument("--events", type=int, default=STORAGE_EVENTS,
                    help="JSONBench events of phase 6g")
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "liquid_tpu_torch_smoke"))
    ap.add_argument("--trash-band", metavar="LABEL",
                    help="only time the grouped scatters (see trash_band)")
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose liquid_tpu_torch --trash-band times")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def clock(phase):  # when each phase ended, for the time budget
        log(f"[clock] phase {phase} done at "
            f"{time.perf_counter() - t_start:.1f} s")

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
    from liquid_tpu_torch.bench.main import TPCH_TABLES
    from liquid_tpu_torch.ops import bitpack_cuda as k1
    from liquid_tpu_torch.ops import grouphist_cuda as k2
    from liquid_tpu_torch.ops import nvcc

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    import numpy
    import pyarrow
    try:  # the server's transport (phase 6j)
        import pyarrow.flight  # noqa: F401
    except ImportError as e:
        raise AssertionError(f"pyarrow {pyarrow.__version__} has no "
                             f"pyarrow.flight: {e}") from e
    log(f"[device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda} numpy {numpy.__version__} pyarrow "
        f"{pyarrow.__version__} (with pyarrow.flight); nvidia-smi: {card}")
    clock("1")

    # 2. build the four kernel sources (one nvcc each) and the native
    #    FSST library (g++), all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native.build)
        libs = nvcc.build_many([k1.SOURCE, k2.SOURCE, k1.PLANES_SOURCE,
                                k1.SELECT_SOURCE], verbose=True)
        native_lib = native.result()
    log(f"[build] {sorted(os.path.relpath(v) for v in libs.values())} + "
        f"{os.path.relpath(native_lib)} in {time.perf_counter() - t0:.2f} s")
    log(f"[sass] K2 shared atomics {k2_sass_atomics(libs[k2.SOURCE])}")
    clock("2")

    # 3. K1 vs plain, every width and batch shape
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    err1 = check_k1(torch, dev)
    log(f"[k1-check] bit-exact over widths 1..64 x B {{1,3,489,4097}}, "
        f"single and interval forms ({time.perf_counter() - t0:.1f} s)")
    clock("3")

    # 4. K2 vs plain, every slot count, width and skew
    t0 = time.perf_counter()
    err2 = check_k2(torch, dev)
    log(f"[k2-check] bit-exact over m {{1,63,8889,16385,65535}} x C "
        f"{{1,4,7,16}} x n {{2048,4097,4005888,4005891}} x uniform/zipf "
        f"slots ({time.perf_counter() - t0:.1f} s)")
    clock("4")

    # 4b. K3 and K4 vs plain, every width, three word counts, both forms
    t0 = time.perf_counter()
    err34 = check_k34(torch, dev)
    log(f"[k34-check] bit-exact over widths 0..64 x W {{256,4096,2^22}} x "
        f"constants {{0,1,random,2^w-1,>=2^w,2^64-1}}, flat and prepped "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    err_sel = check_select(torch, dev)
    log(f"[select-check] K4's fused form bit-exact over W {{1,255,46863,"
        f"2^22}} x P {{1,2,5,16,17}}, widths 0..64 mixed, every op, "
        f"intervals, validity on and off ({time.perf_counter() - t0:.1f} s)")
    clock("4b")

    # 5. scalar main path, counts reset just before and read just after
    t0 = time.perf_counter()
    # `part` for q14 and `partsupp` for phase 6d beside the bench entry
    # point's tables; phase 6g's files written beside them
    paths, spaths, dspaths, sopaths, expect = write_data(
        args.data_dir, args.hits_rows, args.sf, args.events,
        TPCH_TABLES + ("part", "partsupp"))
    log(f"[data] {paths} {spaths} {dspaths} {sopaths} "
        f"({time.perf_counter() - t0:.1f} s)")
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
    # after the launches are read: its selections launch K1 too
    log(f"[members] {json.dumps(check_members(torch, ctx, paths))}")
    clock("5")

    # 6. grouped main path, counts reset just before and read just after
    _reset(counters)
    greport, k2_inputs = run_grouped_path(torch, ctx, paths, expect)
    grouped_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if grouped_launches["group_accumulate"] <= 0:
        raise AssertionError(f"the grouped path did not launch K2: "
                             f"{grouped_launches}")
    clock("6")
    # 6b. the star path, counts reset just before and read just after
    _reset(counters)
    sreport, star_k1_inputs = run_star_path(torch, ctx, expect)
    star_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if star_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"the star path did not launch K1: "
                             f"{star_launches}")
    clock("6b")
    # 6c. the single-table slice, counts reset just before and read after
    _reset(counters)
    log(f"[slice] the data's distinct UserID values: "
        f"{expect['cb_q4'][0][0].as_py()}")
    slice_report = run_slice_path(torch, ctx, expect)
    slice_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if slice_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"the slice did not launch K1: {slice_launches}")
    clock("6c")
    # 6d. TPC-H's multi-table queries, counts reset just before and read
    #     just after
    _reset(counters)
    multi_report, multi_k1_inputs, multi_k2_inputs = run_multi_path(
        torch, ctx, expect)
    multi_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    if multi_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"phase 6d did not launch K1: {multi_launches}")
    clock("6d")
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
    clock("6e")
    # 6f. the cache under a memory budget: W, the bytes the session's cache
    #     holds for the phase's columns, and a cap of W // 4; counts reset
    #     just before and read just after
    w_bytes = pressure_working_set(ctx, pressure_queries())
    cap = w_bytes // 4
    log(f"[pressure] W {w_bytes} bytes (the earlier phases' entries of the "
        f"nine queries' columns); cap W // 4 = {cap} bytes")
    _reset(counters)
    t0 = time.perf_counter()
    pressure_report, pressure_inputs = run_pressure_path(torch, paths, expect,
                                                         cap)
    pressure_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    log(f"[pressure] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(pressure_launches)}; K1 single-form inputs "
        f"{len(pressure_inputs)}")
    if pressure_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"phase 6f did not launch K1: "
                             f"{pressure_launches}")
    clock("6f")
    # 6g. the storage slice: decimal TPC-H, JSONBench and pruning through
    #     an object store; counts reset just before and read just after
    _reset(counters)
    t0 = time.perf_counter()
    decimal_report, decimal_inputs = run_decimal_path(
        torch, ctx, {t: spaths[t] for t in ("lineitem", "part")})
    json_report = run_json_path(torch, spaths["events"])
    pruning_report = run_pruning_path(torch, spaths["hits"])
    storage_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    log(f"[storage] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(storage_launches)}; K1 single-form inputs "
        f"{len(decimal_inputs)}")
    if storage_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"phase 6g did not launch K1: "
                             f"{storage_launches}")
    log(f"[launches] scalar path {json.dumps(scalar_launches)}; grouped "
        f"path {json.dumps(grouped_launches)}; star path "
        f"{json.dumps(star_launches)}; slice {json.dumps(slice_launches)}; "
        f"multi-table {json.dumps(multi_launches)}; classic "
        f"{json.dumps(classic_launches)}; pressure "
        f"{json.dumps(pressure_launches)}; storage "
        f"{json.dumps(storage_launches)}")
    clock("6g")
    # 6h. windows and grouping sets over TPC-DS at this run's scale; counts
    #     reset just before and read just after
    from liquid_tpu_torch.sql import exec as texec
    _reset(counters)
    t0 = time.perf_counter()
    e0 = dict(texec.STATS)
    tpcds_report = run_tpcds_path(torch, dspaths, expect)
    tpcds_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    tpcds_stats = {k: texec.STATS[k] - e0[k]
                   for k in ("windows", "grouping_sets")}
    log(f"[tpcds] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(tpcds_launches)}; executor {json.dumps(tpcds_stats)}")
    if tpcds_launches["cmp_const_many"] <= 0 \
            or min(tpcds_stats.values()) <= 0:
        raise AssertionError(f"phase 6h did not launch K1 or ran no window "
                             f"or grouping set: {tpcds_launches} "
                             f"{tpcds_stats}")
    clock("6h")
    # 6i. multi-device execution on a mesh of shards on the card: the
    #     single-device TPC-DS answers first, then counts reset just before
    #     and read just after
    t0 = time.perf_counter()
    ds_expect = dist_tpcds_expect(torch, dspaths)
    log(f"[dist] single-device TPC-DS answers in "
        f"{time.perf_counter() - t0:.1f} s")
    _reset(counters)
    t0 = time.perf_counter()
    dist_report, dist_summary, shard_planes, select_sets = run_dist_path(
        torch, paths, dspaths, expect, ds_expect)
    dist_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    log(f"[dist] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(dist_launches)}; {json.dumps(dist_summary)}")
    if dist_launches["cmp_const_planes"] <= 0:
        raise AssertionError(f"phase 6i did not launch K4: {dist_launches}")
    clock("6i")
    # 6j. the disaggregated path over the session of phases 5-6b, counts
    #     reset just before and read just after
    _reset(counters)
    t0 = time.perf_counter()
    server_report = run_server_path(torch, ctx, paths, expect, {
        q: r["warm_best_ms"] for q, r in {**report, **greport,
                                          **sreport}.items()})
    server_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    log(f"[server] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(server_launches)}")
    if server_launches["cmp_const_many"] <= 0 \
            or server_launches["group_accumulate"] <= 0:
        raise AssertionError(f"phase 6j did not launch K1 and K2: "
                             f"{server_launches}")
    clock("6j")
    # 6k. the rest of the harness: micro benchmarks, StackOverflow,
    #     schedules, fuzz cases, examples; counts reset just before and
    #     read just after
    _reset(counters)
    t0 = time.perf_counter()
    suites_report = run_suites_path(torch, sopaths, expect, os.path.join(
        args.data_dir, "suites"))
    suites_launches = {**k1.LAUNCHES, **k2.LAUNCHES}
    log(f"[suites] phase {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(suites_launches)}")
    if suites_launches["cmp_const_many"] <= 0:
        raise AssertionError(f"phase 6k did not launch K1: "
                             f"{suites_launches}")
    clock("6k")

    # 7. K1's interval form checked and timed on the main path's own
    #    inputs, the star and multi-table phases' included
    timing = time_k1(torch, ctx, star_k1_inputs + multi_k1_inputs)
    top = max(timing["rows"], key=lambda r: r["bytes"])
    log(f"[k1] largest input {top['column']}: interval / two single "
        f"launches {top['over_two_single']:.3f}, / twice one single "
        f"{top['over_twice_single']:.3f}")
    single = time_k1_single(torch, classic_k1_inputs)
    narrow = time_k1_narrow(torch, pressure_inputs)
    decimal = time_k1_single(torch, decimal_inputs, "6g")
    del pressure_inputs, decimal_inputs
    clock("7")

    # 8. K2 checked and timed on the grouped and multi-table phases' own
    #    inputs
    k2_timing = time_k2(torch, {**k2_inputs, **multi_k2_inputs})
    k2_top = k2_timing["rows"]["cb_groupby"]
    clock("8")

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
    clock("9")

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
    clock("9b")

    # 10. K3 and K4 timed on the micro line's input, K4's fused form on 6i's
    #     shard selections
    k34 = time_k34(torch, shard_planes)
    sel_timing = time_select(torch, select_sets)
    del select_sets
    phases = {"scalar": scalar_launches, "grouped": grouped_launches,
              "star": star_launches, "slice": slice_launches,
              "multi": multi_launches, "classic": classic_launches,
              "pressure": pressure_launches, "storage": storage_launches,
              "tpcds": tpcds_launches, "dist": dist_launches,
              "server": server_launches, "suites": suites_launches,
              "harness": harness_launches,
              "harness_operator_timing": op_launches}

    def launches(name):
        # the main path's launches: the query phases and the micro line
        return sum(phases[p][name]
                   for p in ("scalar", "grouped", "star", "slice", "multi",
                             "classic", "pressure", "storage", "tpcds",
                             "dist", "server", "suites", "harness"))

    def by_phase(name):
        return {p: d.get(name, 0) for p, d in phases.items()}

    kernels = [{
        "name": "cmp_const_many", "route": "cuda",
        "source": "liquid_tpu_torch/ops/csrc/cmp_const_many.cu",
        "replaces": "liquid_tpu/ops/bitpack_pallas.py:212",
        "launches": launches("cmp_const_many"),
        "launches_by_phase": by_phase("cmp_const_many"),
        "max_abs_err": max(err1, timing["max_abs_err"],
                           single["max_abs_err"], narrow["max_abs_err"],
                           decimal["max_abs_err"]),
        "tolerance": 0,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "form": "interval",
        "two_single_ms": top["two_single_ms"],
        "single_ms": top["single_ms"],
        "shape": [top["B"], top["w"], 256], "column": top["column"],
        "single_form": {k: single[k] for k in (
            "inputs", "column", "B", "w", "ms", "plain_ms", "bound_ms",
            "bound_by")},
        "pressure_form": {k: narrow[k] for k in (
            "inputs", "narrow_inputs", "label", "B", "w", "ms", "plain_ms",
            "bound_ms", "bound_by")},
        "decimal_form": {k: decimal[k] for k in (
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
    kernels[-1]["shard_form"] = {k_: k34["shard"][k_] for k_ in (
        "w", "n_words", "c", "ms", "plain_ms", "bound_ms", "bound_by")}
    kernels[-1]["shard_form"]["phase"] = "6i"
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], err_sel,
                                     *(r["max_abs_err"]
                                       for r in sel_timing.values()))
    q6 = sel_timing["tpch_q6"]
    kernels[-1]["select_form"] = {
        "name": "select_planes", "route": "cuda",
        "source": "liquid_tpu_torch/ops/csrc/select_planes.cu",
        "replaces": "liquid_tpu/ops/bitpack_pallas.py:77",
        "launches": launches("cmp_const_planes"),
        "max_abs_err": max(err_sel, *(r["max_abs_err"]
                                      for r in sel_timing.values())),
        "tolerance": 0, "ms": q6["ms"], "plain_ms": q6["plain_ms"],
        "bound_ms": q6["bound_ms"], "bound_by": q6["bound_by"],
        "library_ms": None, "phase": "6i", "query": "tpch_q6",
        "sets": {n: {k_: r[k_] for k_ in (
            "n_words", "preds", "launches", "ms", "warm_ms", "composed_ms",
            "composed_warm_ms", "plain_ms", "bound_ms", "bound_by")}
            for n, r in sel_timing.items()},
        "matches_plain": True}
    summary = {**report, **greport, **sreport, **slice_report,
               **multi_report, **classic_report,
               "pressure": {m: r["summary"] for m, r in
                            pressure_report.items()},
               "pressure_cap": cap, "pressure_working_set": w_bytes,
               "decimal": decimal_report, "pruning": pruning_report,
               "tpcds": tpcds_report, "dist": dist_report,
               "dist_summary": dist_summary, "server": server_report,
               "suites": suites_report,
               "json": {m: json_report[m]["summary"]
                        for m in ("uncapped", "capped")}}
    clock("10")
    log(f"[summary] {json.dumps(summary)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
