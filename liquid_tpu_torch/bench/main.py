"""The port's benchmark entry point (port of the repository's `bench.py`).

    python -m liquid_tpu_torch.bench.main          # one CUDA card, full size
    python -m liquid_tpu_torch.bench.main --device cpu --hits-rows 20000 --sf 0.01

Runs the benchmark's six queries through the public
`LiquidCacheLocalBuilder` SQL path in two of the reference's modes, as
`bench.py` does: `liquid` (transcoded blocks, the fused and star routes)
and then `arrow` (arrow blocks, `Evict`, so the classic path answers),
each on a fresh session over the same parquet.  Per mode: load every
query's columns into the cache, one first run of each query, then the
best of three warm runs, each timed by the host clock up to
`torch.cuda.synchronize()`.  Then it times the engine's operators on the
liquid session's resident columns (CUDA events; card only) and the
packed-compare micro line, K3 `count_gt` over 2^27 rows (2^15 on the
CPU).  It prints ONE JSON line on stdout; logs go to stderr.

The gate, before any number is reported: liquid's and arrow's answers
agree with each other (non-float columns exactly, floats to rtol 1e-9:
the reference's gate, `bench.py:769-819`), and each equals an independent
pyarrow answer computed from the same parquet (`bench/oracle.py`).
`arrow_ms` holds arrow's warm best per query and `vs_baseline` the sum of
arrow's over the sum of liquid's (`vs_baseline_per_query`: the same per
query); `routes` and `arrow_routes` say which route answered.  Nothing
catches a failure: a query that cannot run, or a wrong answer, ends the
run with an error.

Defaults: 4,000,000 synthesized ClickBench `hits` rows and TPC-H SF 1 on
the card; 200,000 rows and SF 0.02 on the CPU (the reference bench's
off-accelerator sizes).  Data is written once, as parquet, under
`--data-dir`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ITERS = 3

#: H100 SXM HBM3 bandwidth (bytes/s, NVIDIA data sheet, 700 W), the
#: operators' roofline
HBM_BYTES_PER_S = 3.35e12

#: what the reference bench runs that the port does not, and why
NOT_PORTED: dict = {}

#: the TPC-H tables the queries read (the star join's dimensions too)
TPCH_TABLES = ("lineitem", "orders", "customer", "supplier", "nation",
               "region")

MICRO_ITERS = 256
MICRO_WIDTH = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def prepare_data(data_dir: str, hits_rows: int, sf: float,
                 tables=TPCH_TABLES) -> dict:
    """Synthesized hits and the named TPC-H tables as parquet, each
    written once -> {table: path}."""
    from liquid_tpu_torch.bench.hits import prepare_hits
    return {"hits": prepare_hits(hits_rows, data_dir),
            **prepare_tpch(data_dir, sf, tables)}


def prepare_tpch(data_dir: str, sf: float, tables=TPCH_TABLES) -> dict:
    """The named TPC-H tables at scale `sf` as parquet, each written once
    -> {table: path}."""
    import pyarrow.parquet as pq
    from liquid_tpu_torch.bench.tpch_data import generate
    os.makedirs(data_dir, exist_ok=True)
    tpch = {n: os.path.join(data_dir, f"liquid_bench_{n}_{sf}.parquet")
            for n in tables}
    missing = [n for n, p in tpch.items() if not os.path.exists(p)]
    if missing:
        made = generate(sf)  # one seed: every table from one draw
        for n in missing:
            pq.write_table(made[n], tpch[n] + ".tmp",
                           row_group_size=1 << 20)
            os.replace(tpch[n] + ".tmp", tpch[n])
    return tpch


def queries(hits_rows, li_rows):
    """(name, {table: [columns]}, rows, sql): the reference bench's six
    queries, same SQL text."""
    q1 = """SELECT l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
 sum(l_extendedprice) as sum_base_price,
 sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
 sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
 avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
 avg(l_discount) as avg_disc, count(*) as count_order
 FROM lineitem WHERE l_shipdate <= date '1998-09-02'
 GROUP BY l_returnflag, l_linestatus
 ORDER BY l_returnflag, l_linestatus"""
    q6 = """SELECT sum(l_extendedprice * l_discount) as revenue
 FROM lineitem WHERE l_shipdate >= date '1994-01-01'
 AND l_shipdate < date '1995-01-01'
 AND l_discount between 0.05 and 0.07 AND l_quantity < 24"""
    q3 = """SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount))
 as revenue, o_orderdate, o_shippriority
 FROM customer, orders, lineitem
 WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
 AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
 AND l_shipdate > date '1995-03-15'
 GROUP BY l_orderkey, o_orderdate, o_shippriority
 ORDER BY revenue desc, o_orderdate, l_orderkey LIMIT 10"""
    return [
        ("cb_filter", {"hits": ["AdvEngineID"]}, hits_rows,
         'SELECT COUNT(*) FROM hits WHERE "AdvEngineID" <> 0'),
        ("cb_groupby",
         {"hits": ["RegionID", "AdvEngineID", "ResolutionWidth"]},
         hits_rows,
         'SELECT "RegionID", SUM("AdvEngineID"), COUNT(*) AS c, '
         'AVG("ResolutionWidth") FROM hits GROUP BY "RegionID" '
         'ORDER BY c DESC, "RegionID" LIMIT 10'),
        ("cb_like", {"hits": ["URL"]}, hits_rows,
         'SELECT COUNT(*) FROM hits WHERE "URL" LIKE \'%yandex%\''),
        ("tpch_q1", {"lineitem": [
            "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]},
         li_rows, q1),
        ("tpch_q6", {"lineitem": [
            "l_extendedprice", "l_discount", "l_shipdate",
            "l_quantity"]}, li_rows, q6),
        ("tpch_q3", {"lineitem": ["l_orderkey", "l_extendedprice",
                                  "l_discount", "l_shipdate"],
                     "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                                "o_shippriority"],
                     "customer": ["c_custkey", "c_mktsegment"]},
         li_rows, q3),
    ]


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _route(fused_before: dict, exec_before: dict) -> str:
    from liquid_tpu_torch.sql import exec as sql_exec
    from liquid_tpu_torch.sql.fused_agg import STATS
    if STATS["star_queries"] > fused_before["star_queries"]:
        return "star"
    if STATS["fused_queries"] > fused_before["fused_queries"]:
        return "fused"
    if any(v > exec_before[k] for k, v in sql_exec.STATS.items()):
        return "classic"
    return "host"


def run_mode(mode, paths, qs, device):
    """Load, first run, best of ITERS -> (best s per query, first
    results, first-run s per query, (load s, first-runs s), ctx, routes,
    spreads)."""
    from liquid_tpu_torch.bench.runner import make_session
    from liquid_tpu_torch.sql import exec as sql_exec
    from liquid_tpu_torch.sql.fused_agg import STATS
    ctx, _cache = make_session(mode, 16 << 30, device=device)
    dev = ctx.device
    for name, path in paths.items():
        ctx.register_parquet(name, path)
    t0 = time.perf_counter()
    for _name, tcols, _rows, _sql in qs:
        for table, cols in tcols.items():
            pt = ctx._tables[table]
            for rg in range(pt.num_row_groups):
                for c in cols:
                    pt.ensure_cached(rg, c)
    t_transcode = time.perf_counter() - t0
    results, first = {}, {}
    t0 = time.perf_counter()
    for name, _tcols, _rows, sql in qs:
        t1 = time.perf_counter()
        results[name] = ctx.sql(sql).to_arrow()
        _sync(dev)
        first[name] = time.perf_counter() - t1
    t_first = time.perf_counter() - t0
    log(f"[{mode}] warm-up: load {t_transcode:.3f} s, first runs "
        f"{t_first:.3f} s")
    times, routes, spreads = {}, {}, {}
    for name, _tcols, rows, sql in qs:
        runs = []
        for _ in range(ITERS):
            fused, classic = dict(STATS), dict(sql_exec.STATS)
            t0 = time.perf_counter()
            ctx.sql(sql).to_arrow()
            _sync(dev)
            runs.append(time.perf_counter() - t0)
            routes[name] = _route(fused, classic)
        times[name] = min(runs)
        spreads[name] = max(runs) / max(times[name], 1e-9)
        log(f"[{mode}] {name}: {times[name] * 1e3:.3f} ms "
            f"({rows / times[name] / 1e6:.1f} Mrows/s) [{routes[name]}] "
            f"spread x{spreads[name]:.2f}")
    return times, results, first, (t_transcode, t_first), ctx, routes, spreads


def modes_agree(a, b) -> bool:
    """The reference bench's gate between two modes' answers: same rows,
    non-float columns equal, float columns to rtol 1e-9 (with numpy's
    default atol 1e-8, as there)."""
    import pyarrow as pa
    if a.num_rows != b.num_rows or a.num_columns != b.num_columns:
        return False
    for ca, cb in zip(a.columns, b.columns):
        if pa.types.is_floating(ca.type) or pa.types.is_decimal(ca.type):
            va = np.asarray(ca.cast(pa.float64()).to_pylist(), dtype=float)
            vb = np.asarray(cb.cast(pa.float64()).to_pylist(), dtype=float)
            if not np.allclose(va, vb, rtol=1e-9, equal_nan=True):
                return False
        elif ca.to_pylist() != cb.to_pylist():
            return False
    return True


def _timed_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` back-to-back calls (CUDA events)."""
    import torch
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


def operator_rooflines(ctx):
    """Per-operator rows/s and HBM roofline fractions on the benchmark's
    own resident columns (CUDA events), or None on the CPU."""
    import torch
    from liquid_tpu_torch.ops import bitpack as bp
    from liquid_tpu_torch.ops import grouphist_cuda
    from liquid_tpu_torch.ops import hashagg as hops
    from liquid_tpu_torch.sql.fused_agg import _in_interval_many, table_state
    if ctx.device.type != "cuda":
        log("[op] operators: not measured on the CPU")
        return None
    out = {}
    preps = table_state(ctx._tables["hits"]).preps
    dev = ctx.device

    def prep_of(col):
        variants = preps.get(col)
        return next(iter(variants.values()))[1] if variants else None

    def emit(name, n, nbytes, per_ms):
        per = per_ms / 1e3
        out[name] = {"rows_per_s": n / per, "gbytes_per_s": nbytes / per / 1e9,
                     "roofline_frac": (nbytes / per) / HBM_BYTES_PER_S,
                     "ms": per_ms}

    def iters_for(nbytes, target=4e9):
        return max(8, min(1024, int(target / max(nbytes, 1))))

    adv = prep_of("AdvEngineID")
    if adv is not None and adv.kind == "planes":
        st = adv.planes_stack
        n = st.shape[0] * 8192
        lo = torch.ones(st.shape[0], dtype=torch.int64, device=dev)
        hi = torch.full((st.shape[0],), 1 << 62, dtype=torch.int64,
                        device=dev)
        # one interval launch: the planes read once, the mask written
        nb = st.numel() * 4 + st.shape[0] * 256 * 4
        emit("encoded_filter", n, nb, _timed_ms(
            lambda: _in_interval_many(st, lo, hi), iters_for(nb)))
        nb = st.numel() * 4 + n * 4
        emit("decode", n, nb, _timed_ms(
            lambda: bp.unpack_bitplanes_many(st), iters_for(nb)))
    reg = prep_of("RegionID")
    if reg is not None and reg.kind == "planes":
        st, refs = reg.planes_stack, reg.refs
        n = st.shape[0] * 8192
        m = 1 << 14
        codes = (bp.unpack_bitplanes_many(st) + refs[:, None]).reshape(-1)
        slot = codes.clamp(0, m).to(torch.int32)
        ones = [torch.ones(n, dtype=torch.int32, device=dev)] * 4
        per = _timed_ms(lambda: grouphist_cuda.group_accumulate(slot, ones, m),
                        20)
        # latency-bound: ns/row is the metric, not a roofline fraction
        out["grouped_accumulate"] = {"rows_per_s": n / (per / 1e3),
                                     "ns_per_row": per * 1e6 / n, "cols": 4,
                                     "ms": per}
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        vz = torch.zeros(n, dtype=torch.bool, device=dev)
        ones64 = torch.ones(n, dtype=torch.int64, device=dev)

        def agg():
            off = bp.unpack_bitplanes_many(st)
            c = (off + refs[:, None]).reshape(-1)
            return hops.hash_rounds_reduce_packed(
                (c,), (vz,), valid, (ones64,), (vz,), ("sum",), 1 << 14,
                0x9E3779B97F4A7C15, rounds=1)
        nb = st.numel() * 4 + n * (8 + 8 + 4)
        emit("hash_groupby", n, nb, _timed_ms(agg, iters_for(nb)))
    url = prep_of("URL")
    if url is not None and url.kind == "dict":
        st = url.codes_stack
        n = st.numel()
        lut = torch.zeros((st.shape[0], url.dmax), dtype=torch.bool,
                          device=dev)

        def gather():
            idx = st.clamp(0, lut.shape[1] - 1).to(torch.int64)
            return torch.gather(lut, 1, idx).sum(dtype=torch.int32)
        nb = n * 4 + n
        emit("dict_verdict_gather", n, nb, _timed_ms(gather, iters_for(nb)))
    for k, v in out.items():
        log(f"[op] {k}: {json.dumps(v)}")
    return out


def micro_kernel_line(device, rows: int):
    """The packed-compare micro line: MICRO_ITERS launches of K3
    `count_gt` with different constants over `rows` rows of a 10-bit
    column (uniform values: every plane bit is a fair coin, seed 0) ->
    rows/s on the card (CUDA events), None on the CPU, where it runs
    the plain version once per constant and is not timed."""
    import torch
    from liquid_tpu_torch.device import words_to_tensor
    from liquid_tpu_torch.ops import bitpack_cuda as k
    rng = np.random.default_rng(0)
    planes = rng.integers(0, 1 << 32, (MICRO_WIDTH, rows // 32),
                          dtype=np.uint32)
    tiles = k.prep(words_to_tensor(planes, device))
    cs = rng.integers(1, 1 << MICRO_WIDTH, MICRO_ITERS)
    acc = torch.zeros((), dtype=torch.int32, device=device)

    def loop():
        nonlocal acc
        for c in cs:
            acc = acc + k.count_gt(tiles, int(c))

    if device.type != "cuda":
        loop()
        return None
    loop()  # warm: build, load, first launches
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    loop()
    e.record()
    torch.cuda.synchronize()
    per = s.elapsed_time(e) / 1e3 / MICRO_ITERS
    log(f"[micro] packed-compare (K3 count_gt): {rows / per / 1e9:.1f} "
        f"Grows/s ({per * 1e3:.4f} ms per launch)")
    return rows / per


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="liquid_tpu_torch benchmark: one JSON line on stdout")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--hits-rows", type=int, default=None)
    ap.add_argument("--sf", type=float, default=None)
    ap.add_argument("--data-dir", default=os.path.join(
        tempfile.gettempdir(), "liquid_tpu_torch_bench"))
    args = ap.parse_args(argv)

    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch
    from liquid_tpu_torch.bench import oracle
    from liquid_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    hits_rows = args.hits_rows or (4_000_000 if on_card else 200_000)
    sf = args.sf or (1.0 if on_card else 0.02)
    micro_rows = 1 << 27 if on_card else 1 << 15
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    log(f"device={device} ({kind}) hits_rows={hits_rows} sf={sf}")

    paths = prepare_data(args.data_dir, hits_rows, sf)
    li_rows = pq.ParquetFile(paths["lineitem"]).metadata.num_rows
    hits_t = pq.read_table(paths["hits"], columns=["URL", "RegionID"])
    card = {"url_distinct": pc.count_distinct(hits_t.column("URL")).as_py(),
            "region_distinct":
                pc.count_distinct(hits_t.column("RegionID")).as_py(),
            "hits_rows": hits_rows, "lineitem_rows": li_rows,
            "hits_bytes": os.path.getsize(paths["hits"]),
            "lineitem_bytes": os.path.getsize(paths["lineitem"])}
    del hits_t
    log(f"data: {card}")
    qs = queries(hits_rows, li_rows)
    expect = oracle.answers(paths, [q[0] for q in qs])

    t_liquid, results, first, warm, ctx, routes, spreads = run_mode(
        "liquid", paths, qs, device)
    ops = operator_rooflines(ctx)
    del ctx
    t_arrow, r_arrow, first_a, warm_a, ctx_a, routes_a, _sa = run_mode(
        "arrow", paths, qs, device)
    del ctx_a
    for name, _, _, _ in qs:
        for mode, got in (("liquid", results[name]), ("arrow", r_arrow[name])):
            if not oracle.same_table(got, expect[name]):
                raise AssertionError(
                    f"{name}: the {mode} answer {got.to_pylist()[:3]} "
                    f"differs from pyarrow's")
        if not modes_agree(results[name], r_arrow[name]):
            raise AssertionError(f"{name}: liquid and arrow answers differ")
    log("correctness gate: liquid == arrow == pyarrow oracle on all queries")

    total_rows = sum(rows for _, _, rows, _ in qs)
    sum_liquid, sum_arrow = sum(t_liquid.values()), sum(t_arrow.values())
    log(f"totals: liquid {sum_liquid * 1e3:.3f} ms, arrow "
        f"{sum_arrow * 1e3:.3f} ms")
    micro = micro_kernel_line(device, micro_rows)
    out = {
        "metric": "e2e_query_rows_per_s",
        "value": total_rows / sum_liquid,
        "unit": "rows/s/chip",
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind},
        "vs_baseline": sum_arrow / sum_liquid,
        "vs_baseline_per_query": {k: t_arrow[k] / t_liquid[k]
                                  for k in t_liquid},
        "queries_ms": {k: v * 1e3 for k, v in t_liquid.items()},
        "arrow_ms": {k: v * 1e3 for k, v in t_arrow.items()},
        "first_run_ms": {k: v * 1e3 for k, v in first.items()},
        "arrow_first_run_ms": {k: v * 1e3 for k, v in first_a.items()},
        "warmup_s": {"liquid_transcode": warm[0],
                     "liquid_first_runs": warm[1],
                     "arrow_load": warm_a[0], "arrow_first_runs": warm_a[1]},
        "data": card,
        "routes": routes,
        "arrow_routes": routes_a,
        "spread": spreads,
        "operators": ops,
        "micro_packed_compare_rows_per_s": micro,
        "micro_rows": micro_rows,
        "gate": "liquid == arrow (non-float exact, float rtol 1e-9) and "
                "each == pyarrow oracle",
        "not_ported": NOT_PORTED,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
