"""GROUP BY ROLLUP / CUBE / GROUPING SETS: the port's
`QueryExecutor._exec_grouping_sets` against the reference's, both on the
CPU, through each package's session over two small seeded parquet tables
(a fact with a string key that holds NULLs, and a dimension joined by
key).

Each set runs as its own grouped query through the port's routes (fused,
star or classic); a key the set leaves out projects as NULL, `grouping()`
folds to 0 or 1, HAVING applies per set, and ORDER BY (NULLS FIRST among
them) and LIMIT apply to the combined rows.  Answers compare under the
tie rule of `test_torch_route_fence.assert_same_answer`: column names and
types equal, floats to rtol 1e-9, everything else exactly."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402


def _tables():
    rng = np.random.default_rng(21)
    n = 4000
    cats = np.array(["red", "green", "blue", "amber"])
    f = pa.table({
        "k1": pa.array(cats[rng.integers(0, 4, n)], mask=rng.random(n) < 0.05),
        "k2": pa.array(rng.integers(0, 6, n)),
        "d_id": pa.array(rng.integers(0, 12, n)),
        "v": pa.array(rng.integers(-100, 1000, n)),
        "x": pa.array(np.round(rng.random(n) * 50, 2)),
    })
    d = pa.table({
        "dk": pa.array(np.arange(12)),
        "d_name": pa.array([f"dept{i % 5}" for i in range(12)]),
        "d_region": pa.array(["north", "south", "east"] * 4),
    })
    return {"f": f, "d": d}


#: (case, sql)
QUERIES = [
    ("rollup", "SELECT k1, k2, sum(v) AS sv, count(*) AS c FROM f "
               "GROUP BY ROLLUP(k1, k2) "
               "ORDER BY k1 NULLS FIRST, k2 NULLS FIRST"),
    ("cube_grouping", "SELECT k1, k2, grouping(k1) AS g1, grouping(k2) AS g2, "
                      "avg(x) AS ax FROM f GROUP BY CUBE(k1, k2) "
                      "ORDER BY g1, g2, k1 NULLS FIRST, k2"),
    ("grouping_sets", "SELECT k1, k2, max(v) AS mv, min(x) AS mx FROM f "
                      "GROUP BY GROUPING SETS ((k1), (k2), ()) "
                      "ORDER BY k1 NULLS FIRST, k2 NULLS FIRST, mv"),
    ("having_per_set", "SELECT k1, k2, count(*) AS c FROM f "
                       "GROUP BY ROLLUP(k1, k2) HAVING count(*) > 150 "
                       "ORDER BY c DESC, k1, k2"),
    ("plain_key_and_rollup", "SELECT k2, k1, sum(x) AS sx FROM f "
                             "GROUP BY k2, ROLLUP(k1) "
                             "ORDER BY k2, k1 NULLS FIRST"),
    ("level_expression", "SELECT k1, k2, sum(v) AS sv, "
                         "grouping(k1) + grouping(k2) AS lvl FROM f "
                         "GROUP BY ROLLUP(k1, k2) "
                         "ORDER BY lvl DESC, k1 NULLS FIRST, k2 LIMIT 12"),
    ("joined_dimension_key", "SELECT d_name, k1, sum(v) AS sv, count(*) AS c "
                             "FROM f, d WHERE d_id = dk AND k2 < 4 "
                             "GROUP BY ROLLUP(d_name, k1) "
                             "ORDER BY d_name NULLS FIRST, k1 NULLS FIRST"),
    ("joined_cube_having", "SELECT d_region, k2, sum(x) AS sx FROM f, d "
                           "WHERE d_id = dk GROUP BY CUBE(d_region, k2) "
                           "HAVING sum(x) > 1000 "
                           "ORDER BY d_region NULLS FIRST, k2 NULLS FIRST"),
]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_grouping_sets")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 28).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 28).build())
    for name, t in _tables().items():
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path, row_group_size=1 << 12)
        jctx.register_parquet(name, path)
        tctx.register_parquet(name, path)
    return jctx, tctx


@pytest.mark.parametrize("case,sql", QUERIES, ids=[c[0] for c in QUERIES])
def test_grouping_sets(sessions, case, sql):
    jctx, tctx = sessions
    g0 = texec.STATS["grouping_sets"]
    ours = tctx.sql(sql).to_arrow()
    assert texec.STATS["grouping_sets"] == g0 + 1
    assert ours.num_rows > 0
    assert_same_answer(ours, jctx, sql)


def test_each_set_runs_a_fused_route(sessions):
    """ROLLUP of two keys over one table is three grouped queries, each on
    the fused route; over a join, each on the star route."""
    _, tctx = sessions
    f0, s0 = tfa.STATS["fused_queries"], tfa.STATS["star_queries"]
    c0 = texec.STATS["classic_aggregates"]
    tctx.sql(QUERIES[0][1]).to_arrow()
    tctx.sql(QUERIES[6][1]).to_arrow()
    assert tfa.STATS["fused_queries"] - f0 >= 3
    assert tfa.STATS["star_queries"] - s0 == 3
    assert texec.STATS["classic_aggregates"] == c0


def test_rolled_up_string_key_is_null_beside_a_real_null(sessions):
    """The set that leaves `k1` out projects it as NULL; the data's own
    NULL k1 forms a group of its own in the sets that keep it."""
    _, tctx = sessions
    out = tctx.sql("SELECT k1, grouping(k1) AS g, count(*) AS c FROM f "
                   "GROUP BY ROLLUP(k1)").to_arrow().to_pylist()
    nulls = [r for r in out if r["k1"] is None]
    assert sorted(r["g"] for r in nulls) == [0, 1]
    total = next(r["c"] for r in nulls if r["g"] == 1)
    assert total == 4000 == sum(r["c"] for r in out if r["g"] == 0)
    assert pa.types.is_string(tctx.sql(
        "SELECT k1, count(*) FROM f GROUP BY ROLLUP(k1)").to_arrow()
        .schema.field("k1").type)
