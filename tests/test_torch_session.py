"""The port's session against the JAX package's, both on the CPU, over the
vendored `nano_hits.parquet` and TPC-H at sf 0.01.

Every query must take the fused scalar route in BOTH packages (checked
through each package's `fused_agg.STATS`) and give the same answer:
counts and integer or scaled-integer results exactly; results summed in
f64 with rtol 1e-12 (the two reduce in different orders).  Shapes the
port does not support yet raise NotImplementedError."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import os  # noqa: E402

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

Q6 = """SELECT sum(l_extendedprice * l_discount) as revenue
 FROM lineitem WHERE l_shipdate >= date '1994-01-01'
 AND l_shipdate < date '1995-01-01'
 AND l_discount between 0.05 and 0.07 AND l_quantity < 24"""

#: (name, sql, rtol for float columns: 0 = exact)
QUERIES = [
    ("cb_filter", 'SELECT COUNT(*) FROM hits WHERE "AdvEngineID" <> 0', 0),
    ("tpch_q6", Q6, 0),
    ("int_eq_stats", 'SELECT SUM("ResolutionWidth"), MIN("ResolutionWidth"), '
     'MAX("ResolutionWidth"), AVG("ResolutionWidth"), COUNT("UserID") '
     'FROM hits WHERE "IsMobile" = 1', 0),
    ("int_or_lt", 'SELECT COUNT(*), SUM("ResolutionWidth" * '
     '"ResolutionHeight") FROM hits WHERE ("RegionID" = 229 OR '
     '"RegionID" < 50) AND "EventDate" >= 15900', 0),
    ("date_between", "SELECT COUNT(*), SUM(l_quantity), AVG(l_extendedprice),"
     " MIN(l_shipdate), MAX(l_shipdate) FROM lineitem WHERE l_shipdate "
     "BETWEEN date '1995-01-01' AND date '1995-12-31'", 0),
    ("float_expr", "SELECT SUM(l_extendedprice * (1 - l_discount) * "
     "(1 + l_tax)), MIN(l_discount), MAX(l_tax) FROM lineitem "
     "WHERE l_quantity >= 10 AND l_discount < 0.04", 0),
    ("linear_key", "SELECT COUNT(l_orderkey), SUM(l_orderkey - l_partkey), "
     "MIN(l_orderkey), MAX(l_orderkey) FROM lineitem "
     "WHERE l_partkey < 500", 0),
    ("float_ne_residual", "SELECT COUNT(*), SUM(l_quantity / l_tax) FROM "
     "lineitem WHERE l_discount <> 0.05 AND l_quantity + l_tax > 30 "
     "AND l_tax > 0", 1e-12),
    ("stddev", "SELECT STDDEV(l_quantity), VAR(l_extendedprice), "
     "COUNT(*) FROM lineitem WHERE l_quantity <= 5", 1e-12),
    ("empty_scan", "SELECT COUNT(*), SUM(l_quantity) FROM lineitem "
     "WHERE l_quantity > 1000", 0),
]

UNSUPPORTED = [
    # shapes no fused route takes, which the classic path answers:
    # count(DISTINCT) of an expression (count(DISTINCT column) has device
    # routes: tests/test_torch_distinct.py), a string ordering inside a
    # residual condition, SELECT DISTINCT (an unordered bare SELECT answers
    # through the fused select: tests/test_torch_select.py)
    'SELECT COUNT(DISTINCT "SearchPhrase" || \'x\') FROM hits',
    'SELECT COUNT(*) FROM hits WHERE "URL" < \'b\' OR "AdvEngineID" + 1 = 3',
    'SELECT COUNT(DISTINCT "UserID" + 1) FROM hits',
    'SELECT DISTINCT "UserID" FROM hits WHERE "AdvEngineID" <> 0 LIMIT 3',
    # an outer join (an inner one takes the star path since the star
    # join was ported: test_scalar_star_join_matches_reference)
    'SELECT SUM(l_quantity) FROM lineitem LEFT JOIN orders ON l_orderkey = '
    'o_orderkey',
]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_session")
    t = ttpch.generate(0.01)
    out = {"hits": NANO_HITS}
    for name in ("lineitem", "orders"):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t[name], out[name], row_group_size=1 << 14)
    return out


@pytest.fixture(scope="module")
def sessions(paths):
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, p in paths.items():
        jctx.register_parquet(name, p)
        tctx.register_parquet(name, p)
    return jctx, tctx


def test_tpch_generator_is_the_references():
    ours = ttpch.generate(0.002)["lineitem"]
    ref = jtpch.generate(0.002)["lineitem"]
    assert ours.equals(ref)


def _assert_same_answer(ours: pa.Table, ref: pa.Table, rtol: float):
    assert ours.column_names == ref.column_names
    assert ours.num_rows == ref.num_rows == 1
    for name in ref.column_names:
        a, b = ours.column(name), ref.column(name)
        assert a.type == b.type, (name, a.type, b.type)
        if pa.types.is_floating(a.type) and rtol:
            np.testing.assert_allclose(
                np.asarray(a.to_numpy(zero_copy_only=False), float),
                np.asarray(b.to_numpy(zero_copy_only=False), float),
                rtol=rtol, equal_nan=True)
        else:
            assert a.to_pylist() == b.to_pylist(), name


@pytest.mark.parametrize("name,sql,rtol", QUERIES, ids=[q[0] for q in QUERIES])
def test_query_matches_reference_on_fused_scalar_route(sessions, name, sql,
                                                        rtol):
    jctx, tctx = sessions
    j0, t0 = jfa.STATS["fused_scalar"], tfa.STATS["fused_scalar"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS["fused_scalar"] == j0 + 1, "reference left the route"
    assert tfa.STATS["fused_scalar"] == t0 + 1, "port left the route"
    _assert_same_answer(ours, ref, rtol)
    # warm: the cached plan answers identically
    again = tctx.sql(sql).to_arrow()
    _assert_same_answer(again, ours, 0)


def test_cpu_run_launches_no_kernel(sessions):
    _, tctx = sessions
    before = bitpack_cuda.LAUNCHES["cmp_const_many"]
    tctx.sql(Q6).to_arrow()
    assert bitpack_cuda.LAUNCHES["cmp_const_many"] == before


def test_metadata_count_matches_reference(sessions):
    jctx, tctx = sessions
    sql = "SELECT COUNT(*) FROM lineitem"
    assert tctx.sql(sql).to_arrow().equals(jctx.sql(sql).to_arrow())


@pytest.mark.parametrize("sql", UNSUPPORTED)
def test_unsupported_shape_raises(sessions, sql):
    """Shapes no fused route takes: each was a raise before the classic
    path; now the classic path answers them as the reference does."""
    jctx, tctx = sessions
    c0 = dict(texec.STATS)
    ours = tctx.sql(sql).to_arrow()
    assert (texec.STATS["classic_aggregates"] + texec.STATS["classic_selects"]
            == c0["classic_aggregates"] + c0["classic_selects"] + 1)
    assert_same_answer(ours, jctx, sql)


def test_scalar_star_join_matches_reference(sessions):
    jctx, tctx = sessions
    sql = ("SELECT SUM(l_quantity) FROM lineitem, orders WHERE l_orderkey = "
           "o_orderkey")
    j0, t0 = jfa.STATS.get("star_queries", 0), tfa.STATS["star_queries"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS.get("star_queries", 0) == j0 + 1
    assert tfa.STATS["star_queries"] == t0 + 1
    _assert_same_answer(ours, ref, 1e-12)


def test_arrow_mode_block_raises_naming_the_reason(paths):
    """Arrow-form blocks have no fused form (`last_bail` names the block
    that is not MEMORY_LIQUID); it was a raise before the classic path,
    whose scan now evaluates the predicate on the decoded blocks."""
    ctx, _ = (LiquidCacheLocalBuilder(device="cpu")
              .with_transcode_on_insert(False).build())
    ctx.register_parquet("lineitem", paths["lineitem"])
    c0 = texec.STATS["classic_aggregates"]
    got = ctx.sql("SELECT COUNT(*) FROM lineitem WHERE l_quantity < 24"
                  ).to_arrow().column(0)[0].as_py()
    assert tfa.STATS["last_bail"].startswith("block")
    assert "MEMORY_LIQUID" in tfa.STATS["last_bail"]
    assert texec.STATS["classic_aggregates"] == c0 + 1
    q = pq.read_table(paths["lineitem"], columns=["l_quantity"])
    assert got == pc.sum(pc.less(q["l_quantity"], 24)).as_py()


def test_reregistration_releases_budget(paths):
    ctx, cache = LiquidCacheLocalBuilder(device="cpu").build()
    ctx.register_parquet("lineitem", paths["lineitem"])
    ctx.sql(Q6)
    assert cache.budget.memory_used > 0
    ctx.register_parquet("lineitem", paths["lineitem"])
    assert cache.budget.memory_used == 0
    assert os.path.exists(paths["lineitem"])
