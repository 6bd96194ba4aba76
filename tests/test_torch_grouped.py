"""The port's grouped fused path against the JAX package's, both on the
CPU, through each package's `LiquidCacheLocalBuilder` over the vendored
`nano_hits.parquet`, TPC-H at sf 0.01 and one table this test writes.

Every query must take the grouped fused route in both packages
(`fused_agg.STATS["fused_grouped"]` +1), and in the port the K2 route
(`fused_pallas` +1) exactly where the reference's gates hold.  Each query
ends in a total order, so the answers compare row for row: keys, counts
and integer or scaled-integer sums exactly, f64 results with rtol 1e-12
(the packages add in different orders)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda, grouphist_cuda  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

#: (name, sql, takes K2 in the port)
QUERIES = [
    ("cb_q7", 'SELECT "AdvEngineID", COUNT(*) FROM hits WHERE "AdvEngineID" '
     '<> 0 GROUP BY "AdvEngineID" ORDER BY COUNT(*) DESC, "AdvEngineID"',
     False),
    ("cb_groupby", 'SELECT "RegionID", SUM("AdvEngineID"), COUNT(*) AS c, '
     'AVG("ResolutionWidth") FROM hits GROUP BY "RegionID" '
     'ORDER BY c DESC, "RegionID" LIMIT 10', False),
    ("cb_q15", 'SELECT "UserID", COUNT(*) FROM hits GROUP BY "UserID" '
     'ORDER BY COUNT(*) DESC, "UserID" LIMIT 10', False),
    ("cb_q35_like", 'SELECT "ClientIP", "ClientIP" - 1, "ClientIP" - 2, '
     '"ClientIP" - 3, COUNT(*) AS c FROM hits GROUP BY "ClientIP", '
     '"ClientIP" - 1, "ClientIP" - 2, "ClientIP" - 3 '
     'ORDER BY c DESC, "ClientIP" LIMIT 10', False),
    ("having", 'SELECT "SearchEngineID", COUNT(*) AS c, '
     'SUM("ResolutionWidth") FROM hits GROUP BY "SearchEngineID" '
     'HAVING COUNT(*) > 100 ORDER BY "SearchEngineID"', False),
    ("min_max", "SELECT l_linenumber, MIN(l_shipdate), MAX(l_extendedprice),"
     " MIN(l_quantity), AVG(l_discount), COUNT(*) FROM lineitem "
     "GROUP BY l_linenumber ORDER BY l_linenumber", False),
    ("float_key", "SELECT l_discount, COUNT(*), STDDEV(l_quantity) FROM "
     "lineitem GROUP BY l_discount ORDER BY l_discount", False),
    ("empty_scan", "SELECT l_suppkey, SUM(l_quantity), COUNT(*) FROM "
     "lineitem WHERE l_quantity > 1000 GROUP BY l_suppkey "
     "ORDER BY l_suppkey", False),
    ("tpch_q15_revenue", "SELECT l_suppkey, sum(l_extendedprice * "
     "(1 - l_discount)) AS total_revenue FROM lineitem WHERE l_shipdate >= "
     "date '1996-01-01' AND l_shipdate < date '1996-04-01' "
     "GROUP BY l_suppkey ORDER BY l_suppkey", False),
    ("k2_narrow", "SELECT k, COUNT(*), SUM(s16) FROM t GROUP BY k "
     "ORDER BY k", True),
    ("k2_wide", "SELECT k, SUM(v), AVG(v) FROM t WHERE s16 > -20000 "
     "GROUP BY k ORDER BY k", True),
    ("null_key_direct", "SELECT kn, COUNT(*), SUM(v) FROM t GROUP BY kn "
     "ORDER BY kn", True),
    ("null_key_hash", "SELECT kn * 2 AS k2, COUNT(kn), MAX(s16) FROM t "
     "GROUP BY kn * 2 ORDER BY k2 NULLS FIRST", False),
]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_grouped")
    paths = {"hits": NANO_HITS, "lineitem": str(d / "lineitem.parquet"),
             "t": str(d / "t.parquet"), "lin": str(d / "lin.parquet")}
    pq.write_table(ttpch.generate(0.01)["lineitem"], paths["lineitem"],
                   row_group_size=1 << 14)
    # 65,536 rows: a key whose domain passes the K2 gates, the same key
    # with 5 % NULLs, an int16 column (narrow sums) and an int64 column
    # in [0, 2^24) whose sums need the hi/lo split
    rng = np.random.default_rng(11)
    n = 1 << 16
    k = rng.integers(0, 4000, n).astype(np.int32)
    pq.write_table(pa.table({
        "k": pa.array(k),
        "kn": pa.array(k, mask=rng.random(n) < 0.05),
        "s16": pa.array(rng.integers(-30000, 30000, n).astype(np.int16)),
        "v": pa.array(rng.integers(0, 1 << 24, n))}), paths["t"],
        row_group_size=1 << 15)
    # 32,768 rows of two sorted keys the transcoder codes as linear
    # blocks: a narrow domain (i // 3) and a wide one (~1M apart, with
    # residual noise)
    i = np.arange(1 << 15, dtype=np.int64)
    pq.write_table(pa.table({
        "ln": pa.array(i // 3),
        "lw": pa.array(i * 1_000_003 + rng.integers(0, 8, i.shape[0])),
        "v": pa.array(rng.integers(0, 1000, i.shape[0]))}), paths["lin"],
        row_group_size=1 << 14)
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        tctx.register_parquet(name, p)
    return jctx, tctx


def _assert_same_answer(ours: pa.Table, ref: pa.Table):
    assert ours.column_names == ref.column_names
    assert ours.num_rows == ref.num_rows
    for name in ref.column_names:
        a, b = ours.column(name), ref.column(name)
        assert a.type == b.type, (name, a.type, b.type)
        if pa.types.is_floating(a.type):
            np.testing.assert_allclose(
                np.asarray(a.to_numpy(zero_copy_only=False), float),
                np.asarray(b.to_numpy(zero_copy_only=False), float),
                rtol=1e-12, equal_nan=True)
        else:
            assert a.to_pylist() == b.to_pylist(), name


@pytest.mark.parametrize("name,sql,k2", QUERIES, ids=[q[0] for q in QUERIES])
def test_query_matches_reference_on_grouped_route(sessions, name, sql, k2):
    jctx, tctx = sessions
    j0 = jfa.STATS["fused_grouped"]
    t0, p0 = tfa.STATS["fused_grouped"], tfa.STATS["fused_pallas"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS["fused_grouped"] == j0 + 1, "reference left the route"
    assert tfa.STATS["fused_grouped"] == t0 + 1, "port left the route"
    assert tfa.STATS["fused_pallas"] == p0 + int(k2)
    _assert_same_answer(ours, ref)
    # warm: the cached plan (and any stage hint) answers identically
    _assert_same_answer(tctx.sql(sql).to_arrow(), ours)


def test_cpu_run_launches_no_kernel(sessions):
    _, tctx = sessions
    before = (bitpack_cuda.LAUNCHES["cmp_const_many"],
              grouphist_cuda.LAUNCHES["group_accumulate"])
    p0 = tfa.STATS["fused_pallas"]
    tctx.sql(dict((q[0], q[1]) for q in QUERIES)["k2_wide"]).to_arrow()
    assert tfa.STATS["fused_pallas"] == p0 + 1
    assert (bitpack_cuda.LAUNCHES["cmp_const_many"],
            grouphist_cuda.LAUNCHES["group_accumulate"]) == before


def test_host_sort_on_an_accelerator_matches_reference(sessions):
    """On a card the executor sorts the result table on the host with
    pyarrow (`device_agg._prefer_host`); that path, with descending keys
    and a stated NULL placement, gives the reference's order too."""
    jctx, tctx = sessions
    sql = ("SELECT l_suppkey, MIN(l_quantity) AS q FROM lineitem "
           "WHERE l_suppkey < 40 GROUP BY l_suppkey "
           "ORDER BY q DESC NULLS LAST, l_suppkey DESC LIMIT 12")
    ref = jctx.sql(sql).to_arrow()
    dev = tctx._exec.device
    tctx._exec.device = torch.device("cuda")
    try:
        ours = tctx.sql(sql).to_arrow()
    finally:
        tctx._exec.device = dev
    _assert_same_answer(ours, ref)


@pytest.mark.parametrize("col,tier", [("ln", "direct"), ("lw", "hash")])
def test_linear_key_direct_only_within_the_table_cap(sessions, col, tier):
    """A GROUP BY key coded as linear blocks gets its blocks' value bounds
    as its domain: a narrow one is addressed directly (TPC-H q18's
    1.5M l_orderkey groups), while a wide one (~3.3e10 values here)
    stays off a direct table larger than its cap and takes the hash
    ladder.  Both answer as the reference, which hashes both."""
    from liquid_tpu_torch.ops import hashagg
    jctx, tctx = sessions
    sql = (f"SELECT {col}, COUNT(*) AS c, SUM(v) AS s FROM lin "
           f"GROUP BY {col} ORDER BY {col}")
    ref = jctx.sql(sql).to_arrow()
    tiers = dict(hashagg.TIERS)
    ours = tctx.sql(sql).to_arrow()
    preps = tctx._tables["lin"]._fused_prep[col].values()
    assert preps and all(ent[1].kind == "linear" for ent in preps)
    moved = {k for k, n in hashagg.TIERS.items() if n != tiers[k]}
    assert moved and ((moved == {"hash"}) == (tier == "hash")), moved
    _assert_same_answer(ours, ref)
