"""Existence probes, composite keys and aliased relations of the port's
fused paths (`liquid_tpu_torch/sql/fused_star.py`, `fused_agg.py`)
against the JAX package's, both on the CPU, through each package's
`LiquidCacheLocalBuilder` over tables this test writes and TPC-H at
SF 0.005 (each package's generator, the same seed).

- `build_exist_probe`: the per-key count and the disambiguator's min /
  max equal the reference's bit for bit over the key domain (the
  reference's slot past the domain counts the rows that do not count;
  the port sends them to a trash band instead), with NULL keys, a NULL
  disambiguator, filters and an empty selection; NOT IN over a key with
  a NULL builds in neither package.
- semi, anti and anti_nn (NOT IN) probes, with and without q21's `<>`
  disambiguator, answer as the reference does on the fused route.
- the sorted chain index of a composite key, (idx, ord, cnt, vals2,
  maxdup), equals the reference's on TPC-H's partsupp; a chain of depth
  8 answers, one of depth 9 raises.
- aliased relations read their base table's preps and existence builds,
  keyed by base column names."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.bench.tpch_queries import QUERIES as TPCH  # noqa: E402
from liquid_tpu.sql import fused_star as jstar  # noqa: E402
from liquid_tpu.sql.parser import parse_sql as jparse  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.oracle import same_table  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql import fused_star as tstar  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_sql as tparse  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

SF = 0.005


def _tables():
    rng = np.random.default_rng(23)
    n = 20_000
    inn = pa.table({
        # keys 100 .. 1099 with repeats; NULL keys never count
        "k": pa.array(rng.integers(100, 1100, n), pa.int64(),
                      mask=rng.random(n) < 0.03),
        "kk": pa.array(rng.integers(100, 1100, n), pa.int64()),
        # the disambiguator: NULLs neither count nor witness
        "m": pa.array(rng.integers(0, 6, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(0, 100, n), pa.int64()),
    })
    n = 12_000
    outr = pa.table({
        # keys below, inside and above the inner domain, and NULLs
        "ok": pa.array(rng.integers(0, 1300, n), pa.int64(),
                       mask=rng.random(n) < 0.04),
        "om": pa.array(rng.integers(0, 6, n), pa.int64(),
                       mask=rng.random(n) < 0.04),
        "og": pa.array(rng.integers(0, 7, n), pa.int64()),
        "val": pa.array(rng.integers(0, 1000, n), pa.int64()),
    })
    out = {"inn": inn, "outr": outr}
    # composite keys with 8 and 9 rows per first key
    rng = np.random.default_rng(29)
    out["cfact"] = pa.table({
        "f_pk": pa.array(rng.integers(1, 31, 2000), pa.int64()),
        "f_sk": pa.array(rng.integers(1, 10, 2000), pa.int64()),
        "f_q": pa.array(rng.integers(1, 50, 2000), pa.int64())})
    for depth in (8, 9):
        pairs = [(p, s) for p in range(1, 31) for s in range(1, depth + 1)]
        out[f"cdim{depth}"] = pa.table({
            "c_pk": pa.array([p for p, _ in pairs], pa.int64()),
            "c_sk": pa.array([s for _, s in pairs], pa.int64()),
            "c_cost": pa.array([float(p * 3 + s) for p, s in pairs])})
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_exist")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, t in _tables().items():
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path, row_group_size=1 << 13)
        jctx.register_parquet(name, path)
        tctx.register_parquet(name, path)
    jctx.paths = {n: str(d / f"{n}.parquet") for n in ("inn", "outr")}
    for side, gen, ctx in (("j", jtpch, jctx), ("t", ttpch, tctx)):
        for name, t in gen.generate(SF).items():
            path = str(d / f"{side}_{name}.parquet")
            pq.write_table(t, path, row_group_size=1 << 16)
            ctx.register_parquet(name, path)
    return jctx, tctx


def _where(parse, cond):
    return None if cond is None else parse(
        f"SELECT * FROM inn WHERE {cond}").where


#: (case, the inner relation's local WHERE, the disambiguator column)
BUILDS = [
    ("plain", None, None),
    ("filtered", "v > 40", None),
    ("residual", "v + kk > 700", None),
    ("disambiguator", None, "m"),
    ("filtered_disambiguator", "v < 70", "m"),
    ("empty_selection", "v > 1000000", None),
]


@pytest.mark.parametrize("name,cond,mm", BUILDS, ids=[b[0] for b in BUILDS])
def test_exist_build_matches_reference(sessions, name, cond, mm):
    jctx, tctx = sessions
    ref = jstar.build_exist_probe(jctx._tables["inn"], "k",
                                  _where(jparse, cond), mm)
    ours = tstar.build_exist_probe(tctx._tables["inn"], "k",
                                   _where(tparse, cond), mm)
    assert ref is not None and ours is not None
    cnt = np.asarray(ref["cnt"])
    if name == "empty_selection":
        assert not cnt.any() and not ours.cnt.any()
        return
    m = ref["span"] + 1  # the domain; the reference's slot m is its trash
    assert (ours.lo, ours.span) == (ref["lo"], ref["span"])
    assert ours.cnt.dtype == torch.int32 and ours.cnt.shape == (m,)
    np.testing.assert_array_equal(ours.cnt.numpy(), cnt[:m])
    assert cnt[:m].sum() > 0
    if mm is None:
        assert ours.minv is None and ref["minv"] is None
        return
    for got, want in ((ours.minv, ref["minv"]), (ours.maxv, ref["maxv"])):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:m])


def test_not_in_over_a_null_key_builds_in_neither(sessions):
    jctx, tctx = sessions
    assert jstar.build_exist_probe(jctx._tables["inn"], "k", None, None,
                                   require_nonnull_key=True) is None
    assert tstar.build_exist_probe(tctx._tables["inn"], "k", None, None,
                                   require_nonnull_key=True) is None
    ours = tstar.build_exist_probe(tctx._tables["inn"], "kk", None, None,
                                   require_nonnull_key=True)
    assert ours is not None and ours.cached


def test_exist_build_is_cached_and_charged(sessions):
    _, tctx = sessions
    inn = tctx._tables["inn"]
    a = tstar.build_exist_probe(inn, "k", _where(tparse, "v > 3"), "m")
    b = tstar.build_exist_probe(inn, "k", _where(tparse, "v > 3"), "m")
    assert a is b and a.cached and a.nbytes > 0
    used = tctx.cache.budget.memory_used
    tfa.table_state(inn).release()
    assert not tfa.table_state(inn).exist_builds and not a.cached
    assert tctx.cache.budget.memory_used <= used - a.nbytes


#: (case, sql) over the outer table: every probe mode
PROBES = [
    ("semi", "SELECT count(*) AS n, sum(val) AS s FROM outr WHERE EXISTS "
     "(SELECT * FROM inn WHERE k = ok AND v > 20)"),
    ("anti", "SELECT count(*) AS n, sum(val) AS s FROM outr WHERE NOT "
     "EXISTS (SELECT * FROM inn WHERE k = ok AND v > 20)"),
    ("in", "SELECT count(*) AS n FROM outr WHERE ok IN (SELECT k FROM inn "
     "WHERE v > 90)"),
    ("not_in_anti_nn", "SELECT count(*) AS n FROM outr WHERE ok NOT IN "
     "(SELECT kk FROM inn WHERE v > 90)"),
    ("semi_disambiguator", "SELECT og, count(*) AS n FROM outr WHERE EXISTS "
     "(SELECT * FROM inn WHERE k = ok AND m <> om) GROUP BY og ORDER BY og"),
    ("anti_disambiguator", "SELECT og, count(*) AS n FROM outr WHERE og > 1 "
     "AND NOT EXISTS (SELECT * FROM inn WHERE k = ok AND m <> om AND v < 50)"
     " GROUP BY og ORDER BY og"),
]


def _fresh_reference(jctx, sql) -> pa.Table:
    """The reference's answer from a session of its own: its fused plan
    cache keys a probe by the conjunct's render, which shows a subquery
    only by its kind, so `ok IN (...)` and `ok NOT IN (...)` over other
    columns share one cached plan (the second answers as the first)."""
    ctx, _ = JBuilder().with_max_memory_bytes(1 << 28).build()
    for name, path in jctx.paths.items():
        ctx.register_parquet(name, path)
    return ctx.sql(sql).to_arrow()


@pytest.mark.parametrize("name,sql", PROBES, ids=[c[0] for c in PROBES])
def test_probe_answers_as_the_reference(sessions, name, sql):
    jctx, tctx = sessions
    f0 = tfa.STATS["fused_queries"]
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["fused_queries"] == f0 + 1
    ref = _fresh_reference(jctx, sql)
    assert ours.column_names == ref.column_names
    assert same_table(ours, ref.columns), (ours.to_pylist(), ref.to_pylist())
    # the plan pins the probe: a warm run answers the same
    assert same_table(tctx.sql(sql).to_arrow(), ref.columns)


@pytest.mark.parametrize("name,sql", [PROBES[0], PROBES[4]],
                         ids=[PROBES[0][0], PROBES[4][0]])
def test_uncharged_exist_build_leaves_its_plan_uncached(sessions, monkeypatch,
                                                       name, sql):
    """With the budget full, an existence build is neither cached nor
    kept alive by a cached fused plan: every run builds it again under a
    new identity, no plan is added for it, and the budget's count stays
    within its limit.  Every table's builds are released first, so that
    evicting older builds cannot make room either."""
    _, tctx = sessions
    want = tctx.sql(sql).to_arrow()
    inn, outr = tctx._tables["inn"], tctx._tables["outr"]
    for t in tctx._tables.values():
        tfa.table_state(t).release()
    budget, plans = tctx.cache.budget, tfa.table_state(outr).plans
    monkeypatch.setattr(budget, "max_memory_bytes", budget.memory_used)
    n_plans, used = len(plans), budget.memory_used
    f0 = tfa.STATS["fused_queries"]
    for _ in range(3):
        assert same_table(tctx.sql(sql).to_arrow(), want.columns)
        assert not tfa.table_state(inn).exist_builds and len(plans) == n_plans
        assert budget.memory_used == used <= budget.max_memory_bytes
    assert tfa.STATS["fused_queries"] == f0 + 3


def test_in_and_not_in_keep_their_own_plans(sessions):
    """The port keys a probe's plan by the whole conjunct: after the IN
    query, the NOT IN query over another column still answers NOT IN
    (4,265 rows here where the reference's shared plan answers 7,632)."""
    jctx, tctx = sessions
    a, b = PROBES[2][1], PROBES[3][1]
    assert tctx.sql(a).to_arrow()["n"][0] != tctx.sql(b).to_arrow()["n"][0]
    assert same_table(tctx.sql(b).to_arrow(),
                      _fresh_reference(jctx, b).columns)


def _chain_probe(cache: dict):
    got = [pb for pb in cache.values() if pb.chain is not None]
    assert len(got) == 1
    return got[0]


def test_partsupp_chain_matches_reference(sessions):
    jctx, tctx = sessions
    ref_t, ours_t = jctx.sql(TPCH[9]).to_arrow(), tctx.sql(TPCH[9]).to_arrow()
    assert ours_t.num_rows == ref_t.num_rows > 0
    ref = _chain_probe(jctx._tables["partsupp"]._star_probe_cache)
    ours = _chain_probe(tfa.table_state(tctx._tables["partsupp"]).dim_builds)
    assert (ours.lo, ours.hi, ours.nrows) == (ref.lo, ref.hi, ref.nrows)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    (o_ord, o_cnt, o_vals2, o_max), (r_ord, r_cnt, r_vals2, r_max) = \
        ours.chain, ref.chain
    assert o_max == r_max == 4  # the generator's four suppliers per part
    assert (o_ord.dtype, o_cnt.dtype) == (torch.int32, torch.int32)
    for got, want in ((o_ord, r_ord), (o_cnt, r_cnt), (o_vals2, r_vals2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


COMPOSITE = ("SELECT f_sk, sum(c_cost * f_q) AS a, count(*) AS n FROM cfact, "
             "{dim} WHERE c_pk = f_pk AND c_sk = f_sk GROUP BY f_sk "
             "ORDER BY f_sk")


def test_chain_of_depth_8_answers(sessions):
    jctx, tctx = sessions
    sql = COMPOSITE.format(dim="cdim8")
    s0 = tfa.STATS["star_queries"]
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["star_queries"] == s0 + 1
    assert same_table(ours, jctx.sql(sql).to_arrow().columns)
    probe = _chain_probe(tfa.table_state(tctx._tables["cdim8"]).dim_builds)
    assert probe.chain[3] == tstar.MAX_COMPOSITE_DUP == 8


def test_chain_of_depth_9_raises(sessions):
    """A chain deeper than 8 rows per key leaves the star route (`star_
    last_bail` names the depth); it was a raise before the classic path,
    whose join answers as the reference's."""
    jctx, tctx = sessions
    sql = COMPOSITE.format(dim="cdim9")
    s0, c0 = tfa.STATS["star_queries"], texec.STATS["classic_aggregates"]
    ours = tctx.sql(sql).to_arrow()
    assert "composite chain depth 9" in tfa.STATS["star_last_bail"]
    assert tfa.STATS["star_queries"] == s0
    assert texec.STATS["classic_aggregates"] == c0 + 1
    assert same_table(ours, jctx.sql(sql).to_arrow().columns)


def test_aliased_relations_share_their_base_builds(sessions):
    """q21's lineitem l1 (the fact) and l2 / l3 (existence probes) read
    lineitem's own preps and existence builds under base column names;
    q7's nation n1 / n2 build their dimensions into nation's cache."""
    jctx, tctx = sessions
    for q in (21, 7):
        assert same_table(tctx.sql(TPCH[q]).to_arrow(),
                          jctx.sql(TPCH[q]).to_arrow().columns)
    li = tfa.table_state(tctx._tables["lineitem"])
    assert li.preps and not any("__" in c for c in li.preps)
    keys = [(ck[0], ck[1]) for ck in li.exist_builds]
    assert keys.count(("l_orderkey", "l_suppkey")) == 2  # l2 and l3
    nation = tfa.table_state(tctx._tables["nation"])
    prefixes = {ck[0] for ck in nation.dim_builds}
    assert {"n1", "n2"} <= prefixes


@pytest.mark.parametrize("sql", [
    "SELECT count(*) AS n FROM outr WHERE og IN ({})",
    "SELECT n_name, count(*) AS n FROM supplier, nation WHERE s_nationkey "
    "= n_nationkey AND n_nationkey IN ({}) GROUP BY n_name ORDER BY n_name",
], ids=["fused", "star_dimension"])
def test_in_lists_key_their_own_plans(sessions, sql):
    """A cached plan or dimension build is keyed by its predicates whole:
    an IN list's display name shows only its kind, so a cache keyed by it
    answered `IN (1, 2)` with the plan of an earlier `IN (3, 4, 5)`."""
    _, tctx = sessions
    a, b = sql.format("1, 2"), sql.format("3, 4, 5")
    first = tctx.sql(a).to_arrow()
    assert tctx.sql(b).to_arrow() != first
    assert tctx.sql(a).to_arrow() == first
