"""The port's fused star join (`liquid_tpu_torch/sql/fused_star.py`)
against the JAX package's, both on the CPU, through each package's
`LiquidCacheLocalBuilder`.

Every in-slice case of `tests/test_fused_star.py` (star and snowflake
trees, INNER joins), composite keys, existence probes and aliased
relations, and TPC-H q3 (the bench's text,
with its `l_orderkey` tie-break), q5, q10 and q19 at sf 0.005 must take
the star route in both packages (`STATS["star_queries"]` +1) and give
the same answer: keys, counts, strings and integers exactly, floats to
rtol 1e-9.  The TPC-H tables come from each package's own generator with the
same seed.  Shapes the star route does not take pass to the classic
join path, which answers as the reference's does.  The probe and the q3 dimension build are held bit for bit
against the reference's."""
import pytest

torch = pytest.importorskip("torch")

import datetime  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.bench.tpch_queries import QUERIES as TPCH  # noqa: E402
from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import main as bench  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql import fused_star as tstar  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from tests.test_torch_route_fence import assert_same_answer  # noqa: E402

SF = 0.005
Q3 = next(q[3] for q in bench.queries(1, 1) if q[0] == "tpch_q3")
Q5 = """SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
 FROM customer, orders, lineitem, supplier, nation, region
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
 AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
 AND r_name = 'ASIA' AND o_orderdate >= date '1994-01-01'
 AND o_orderdate < date '1994-01-01' + interval '1' year
 GROUP BY n_name ORDER BY revenue DESC"""
Q10 = """SELECT c_custkey, c_name,
 sum(l_extendedprice * (1 - l_discount)) AS revenue,
 c_acctbal, n_name, c_address, c_phone, c_comment
 FROM customer, orders, lineitem, nation
 WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
 AND o_orderdate >= date '1993-10-01'
 AND o_orderdate < date '1993-10-01' + interval '3' month
 AND l_returnflag = 'R' AND c_nationkey = n_nationkey
 GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
 c_comment ORDER BY revenue DESC, c_custkey LIMIT 20"""


def _fact_dim(n=5000, dn=64, seed=0, null_fk=False, dup_dim=False):
    """The reference test's fact and dimension: some fact keys miss."""
    rng = np.random.default_rng(seed)
    fk = rng.integers(0, dn + 10, n)
    fact = pa.table({
        "fk": pa.array(fk, pa.int64()) if not null_fk else pa.array(
            [None if i % 7 == 0 else int(v) for i, v in enumerate(fk)],
            pa.int64()),
        "amt": pa.array(rng.random(n) * 100),
        "qty": pa.array(rng.integers(0, 50, n), pa.int64()),
    })
    dk = np.arange(dn, dtype=np.int64)
    if dup_dim:
        dk = np.concatenate([dk, dk[:5]])
    dim = pa.table({
        "dk": pa.array(dk),
        "grp": pa.array([f"g{int(k) % 7}" for k in dk]),
        "w": pa.array((dk % 13).astype(np.float64)),
    })
    return fact, dim


def _synthetic_tables() -> dict:
    fact, dim = _fact_dim()
    nfact, _ = _fact_dim(null_fk=True)
    _, ddim = _fact_dim(dup_dim=True)
    rng = np.random.default_rng(3)
    n = 4000
    sf_fact = pa.table({"mk": pa.array(rng.integers(0, 50, n), pa.int64()),
                        "samt": pa.array(rng.random(n))})
    mid = pa.table({"m_id": pa.array(np.arange(50, dtype=np.int64)),
                    "lk": pa.array((np.arange(50) % 8).astype(np.int64))})
    leaf = pa.table({"l_id": pa.array(np.arange(8, dtype=np.int64)),
                     "lname": pa.array([f"L{i}" for i in range(8)])})
    rng = np.random.default_rng(4)
    n = 3000
    cx_fact = pa.table({"ak": pa.array(rng.integers(0, 40, n), pa.int64()),
                        "bk": pa.array(rng.integers(0, 40, n), pa.int64()),
                        "v": pa.array(rng.integers(0, 100, n), pa.int64())})
    da = pa.table({"a_id": pa.array(np.arange(40, dtype=np.int64)),
                   "a_tag": pa.array((np.arange(40) % 5).astype(np.int64))})
    db = pa.table({"b_id": pa.array(np.arange(40, dtype=np.int64)),
                   "b_tag": pa.array((np.arange(40) % 5).astype(np.int64))})
    rng = np.random.default_rng(5)
    n = 3000
    base = datetime.date(1995, 1, 1)
    dt_fact = pa.table({"ok": pa.array(rng.integers(0, 100, n), pa.int64()),
                        "damt": pa.array(rng.random(n))})
    dt_dim = pa.table({
        "o_id": pa.array(np.arange(100, dtype=np.int64)),
        "odate": pa.array([base + datetime.timedelta(days=int(i) % 10)
                           for i in range(100)], pa.date32()),
        "prio": pa.array((np.arange(100) % 3).astype(np.int64))})
    # a composite key: (ps_pk, ps_sk) unique only as a pair
    rng = np.random.default_rng(3)
    ps_fact = pa.table({
        "l_pk": pa.array(rng.integers(1, 41, 600), pa.int64()),
        "l_sk": pa.array(rng.integers(1, 7, 600), pa.int64()),
        "l_qty": pa.array(rng.integers(1, 50, 600), pa.int64())})
    pairs = [(p, s) for p in range(1, 41) for s in range(1, 7)]
    ps = pa.table({"ps_pk": pa.array([p for p, _ in pairs], pa.int64()),
                   "ps_sk": pa.array([s for _, s in pairs], pa.int64()),
                   "ps_cost": pa.array([(p * 31 + s * 7) % 97 + 0.25
                                        for p, s in pairs])})
    # nine suppliers per part: a chain deeper than MAX_COMPOSITE_DUP
    deep = [(p, s) for p in range(1, 41) for s in range(1, 10)]
    psdeep = pa.table({"ps_pk": pa.array([p for p, _ in deep], pa.int64()),
                       "ps_sk": pa.array([s for _, s in deep], pa.int64()),
                       "ps_cost": pa.array([float(p + s) for p, s in deep])})
    # more groups than the packed fetch holds (65,536): the re-packed
    # full fetch re-attaches the FD keys
    rng = np.random.default_rng(6)
    n = 80_000
    big_fact = pa.table({"bk2": pa.array(rng.permutation(n), pa.int64()),
                         "bq": pa.array(rng.integers(0, 9, n), pa.int64())})
    big_dim = pa.table({"bd": pa.array(np.arange(n, dtype=np.int64)),
                        "bw": pa.array(np.arange(n) % 97, pa.int64())})
    return {"fact": fact, "dim": dim, "nfact": nfact, "ddim": ddim,
            "sffact": sf_fact, "mid": mid, "leaf": leaf, "cxfact": cx_fact,
            "da": da, "db": db, "dtfact": dt_fact, "dtdim": dt_dim,
            "psfact": ps_fact, "ps": ps, "psdeep": psdeep,
            "bigfact": big_fact,
            "bigdim": big_dim}


#: (name, sql) of the in-slice cases of the reference's star tests
CASES = [
    ("basic_grouped", "SELECT grp, sum(amt) s, count(*) c FROM fact "
     "JOIN dim ON fk = dk GROUP BY grp ORDER BY grp"),
    ("scalar_no_group", "SELECT sum(amt * w), count(*), min(qty), max(w) "
     "FROM fact, dim WHERE fk = dk AND qty < 25 AND w > 2"),
    ("null_fact_keys_never_match", "SELECT grp, count(*) c FROM nfact "
     "JOIN dim ON fk = dk GROUP BY grp ORDER BY grp"),
    ("empty_dim_annihilates", "SELECT grp, count(*) c FROM fact JOIN dim "
     "ON fk = dk WHERE w > 1e9 GROUP BY grp"),
    ("snowflake_cascade", "SELECT lname, sum(samt) s, count(*) c "
     "FROM sffact, mid, leaf WHERE mk = m_id AND lk = l_id AND lname <> 'L3' "
     "GROUP BY lname ORDER BY lname"),
    ("cross_dim_residual_equality", "SELECT a_tag, sum(v) s FROM cxfact, da, "
     "db WHERE ak = a_id AND bk = b_id AND a_tag = b_tag GROUP BY a_tag "
     "ORDER BY a_tag"),
    ("date_group_key_from_dim", "SELECT odate, prio, sum(damt) s FROM dtfact "
     "JOIN dtdim ON ok = o_id GROUP BY odate, prio ORDER BY odate, prio"),
    ("fd_full_fetch", "SELECT bk2, bw, sum(bq) s FROM bigfact JOIN bigdim "
     "ON bk2 = bd GROUP BY bk2, bw ORDER BY bk2"),
    ("count_distinct_fold", "SELECT grp, count(DISTINCT qty) AS d, "
     "sum(amt) s, avg(qty) a, min(w) mn, count(*) c FROM fact JOIN dim "
     "ON fk = dk GROUP BY grp ORDER BY d DESC, grp LIMIT 4"),
    ("count_distinct_fold_scalar", "SELECT count(DISTINCT qty), "
     "count(DISTINCT fk), max(amt) FROM fact, dim WHERE fk = dk AND w > 3"),
    # composite keys, existence probes and aliased relations
    ("composite_key", "SELECT l_sk, SUM(ps_cost * l_qty) AS amount "
     "FROM psfact, ps WHERE ps_pk = l_pk AND ps_sk = l_sk GROUP BY l_sk "
     "ORDER BY l_sk"),
    ("exists_probe", "SELECT grp, count(*) c FROM fact, dim WHERE fk = dk "
     "AND EXISTS (SELECT * FROM mid WHERE m_id = qty) GROUP BY grp "
     "ORDER BY grp"),
    ("not_exists_probe", "SELECT grp, sum(amt) s FROM fact, dim "
     "WHERE fk = dk AND NOT EXISTS (SELECT * FROM mid WHERE m_id = qty "
     "AND lk > 2) GROUP BY grp ORDER BY grp"),
    ("aliased", "SELECT d.grp, count(*) FROM fact f JOIN dim d "
     "ON f.fk = d.dk GROUP BY d.grp ORDER BY 1"),
    ("self_join_aliases", "SELECT d1.a_tag, d2.a_tag AS t2, sum(v) s "
     "FROM cxfact, da d1, da d2 WHERE ak = d1.a_id AND bk = d2.a_id "
     "GROUP BY d1.a_tag, d2.a_tag ORDER BY 1, 2"),
    ("tpch_q3", Q3),
    ("tpch_q5", Q5),
    ("tpch_q10", Q10),
    ("tpch_q19", TPCH[19]),
]


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_star")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, t in _synthetic_tables().items():
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path)
        jctx.register_parquet(name, path)
        tctx.register_parquet(name, path)
    # TPC-H: each package's generator, the same seed
    for side, gen, ctx in (("j", jtpch, jctx), ("t", ttpch, tctx)):
        for name, t in gen.generate(SF).items():
            path = str(d / f"{side}_{name}.parquet")
            pq.write_table(t, path, row_group_size=1 << 16)
            ctx.register_parquet(name, path)
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
                rtol=1e-9, equal_nan=True)
        else:
            assert a.to_pylist() == b.to_pylist(), name


@pytest.mark.parametrize("name,sql", CASES, ids=[c[0] for c in CASES])
def test_query_matches_reference_on_star_route(sessions, name, sql):
    jctx, tctx = sessions
    j0, t0 = jfa.STATS.get("star_queries", 0), tfa.STATS["star_queries"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert jfa.STATS.get("star_queries", 0) == j0 + 1, \
        f"reference left the star route: {jfa.STATS.get('star_last_bail')}"
    assert tfa.STATS["star_queries"] == t0 + 1
    _assert_same_answer(ours, ref)
    if name.startswith("tpch"):
        assert ours.num_rows > 0
    # warm: the cached star plan answers identically
    _assert_same_answer(tctx.sql(sql).to_arrow(), ours)
    assert tfa.STATS["star_queries"] == t0 + 2


def test_cpu_star_run_launches_no_kernel(sessions):
    _, tctx = sessions
    before = bitpack_cuda.LAUNCHES["cmp_const_many"]
    tctx.sql(Q3).to_arrow()
    assert bitpack_cuda.LAUNCHES["cmp_const_many"] == before


#: (case, sql, the reason the star route gives for passing it on)
OUT_OF_SLICE = [
    ("duplicate_dim_key", "SELECT grp, count(*) c FROM fact JOIN ddim "
     "ON fk = dk GROUP BY grp ORDER BY grp", "N:M join"),
    ("outer_join", "SELECT grp, count(*) c FROM fact LEFT JOIN dim "
     "ON fk = dk GROUP BY grp ORDER BY grp", "left join"),
    ("composite_key", "SELECT l_sk, SUM(ps_cost * l_qty) AS amount "
     "FROM psfact, psdeep WHERE ps_pk = l_pk AND ps_sk = l_sk GROUP BY l_sk",
     "composite chain depth 9"),
    ("exists", "SELECT grp, count(*) c FROM fact, dim WHERE fk = dk AND "
     "EXISTS (SELECT * FROM mid WHERE m_id > qty) GROUP BY grp",
     "a correlated subquery"),
    # count(DISTINCT column) folds on the host (CASES); of an expression
    # it has no route
    ("count_distinct", "SELECT grp, count(DISTINCT qty + 1) FROM fact JOIN "
     "dim ON fk = dk GROUP BY grp", "aggregate kind count_distinct"),
    ("aliased", "SELECT d.grp, count(*) FROM fact f JOIN (SELECT dk, grp "
     "FROM dim) d ON f.fk = d.dk GROUP BY d.grp", "derived-table relation"),
]


@pytest.mark.parametrize("name,sql,names", OUT_OF_SLICE,
                         ids=[c[0] for c in OUT_OF_SLICE])
def test_out_of_slice_shapes_raise(sessions, name, sql, names):
    """Shapes the star route does not take: it passes them on (the
    reason in `star_last_bail` or the fused aggregate's `last_bail`) and
    the classic join path answers as the reference's does.  Each was a
    raise before the classic path."""
    jctx, tctx = sessions
    if name == "exists":
        # no equality correlation: the reference's lookup fails on it
        # (a merge without keys) and the port names it
        with pytest.raises(NotImplementedError,
                           match="no equality correlation"):
            tctx.sql(sql).to_arrow()
        return
    ref = jctx.sql(sql).to_arrow()
    t0 = tfa.STATS["star_queries"]
    for _ in range(2):  # a cached refusal hands over again
        c0 = texec.STATS["classic_aggregates"]
        d0 = tfa.STATS["star_dup_bails"]
        ours = tctx.sql(sql).to_arrow()
        assert texec.STATS["classic_aggregates"] == c0 + 1
        if names == "N:M join":  # found by the uniqueness fetch
            assert tfa.STATS["star_dup_bails"] == d0 + 1
        else:
            assert names in (tfa.STATS.get("star_last_bail", "")
                             + tfa.STATS.get("last_bail", ""))
        assert_same_answer(ours, jctx, sql)
    assert tfa.STATS["star_queries"] == t0
    assert ours.num_rows == ref.num_rows


class _Env:
    """The decode/null surface `probe_dims` reads."""

    def __init__(self, cols, nulls):
        self.cols, self._nulls, self.probe_j = cols, nulls, {}

    def decode(self, name, _dt):
        return self.cols[name]

    def nulls(self, name):
        return self._nulls[name]


def test_probe_matches_reference_bit_for_bit():
    rng = np.random.default_rng(17)
    n, tbl_n, lo = 20_000, 1 << 12, 1_000
    idx = np.where(rng.random(tbl_n) < 0.3, -1,
                   rng.integers(0, 50_000, tbl_n)).astype(np.int32)
    # keys below lo, above the table, inside it, and NULLs
    keys = rng.integers(lo - 300, lo + tbl_n + 300, n).astype(np.int64)
    knull = rng.random(n) < 0.05
    sel = rng.random(n) < 0.9
    probes = ((0, "k", 0, 1),)
    j_arrays = [jnp.asarray(idx), jnp.asarray(np.int64(lo))]
    j_probe = {}
    j_sel = jfa.probe_dims(probes, j_arrays, lambda _n, _d: jnp.asarray(keys),
                           lambda _n: jnp.asarray(knull), j_probe,
                           jnp.asarray(sel))
    env = _Env({"k": torch.from_numpy(keys)}, {"k": torch.from_numpy(knull)})
    t_sel = tfa.probe_dims(probes, [torch.from_numpy(idx),
                                    torch.tensor(lo, dtype=torch.int64)],
                           env, torch.from_numpy(sel))
    j_ref = np.asarray(j_probe[0])
    j_got = env.probe_j[0].numpy()
    assert j_got.dtype == j_ref.dtype == np.int32
    np.testing.assert_array_equal(j_got, j_ref)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
    assert (j_got[knull] == -1).all() and (j_got[keys < lo] == -1).all()
    assert (j_got[keys >= lo + tbl_n] == -1).all()
    assert (j_got >= 0).sum() > n // 2


def _orders_probe(cache: dict, key_of):
    """q3's orders build: keyed on o_orderkey with one predicate (q5 and
    q10 build orders under two)."""
    got = [pb for k, pb in cache.items() if key_of(k) == ("o_orderkey", 1)]
    assert len(got) == 1
    return got[0]


def test_q3_dimension_build_matches_reference(sessions):
    jctx, tctx = sessions
    jctx.sql(Q3).to_arrow()
    tctx.sql(Q3).to_arrow()
    ref = _orders_probe(jctx._tables["orders"]._star_probe_cache,
                        lambda k: (k[0][4], len(k[1])))
    ours = _orders_probe(tctx._tables["orders"]._star_probe_cache,
                         lambda k: (k[1], len(k[4])))
    assert (ours.lo, ours.hi, ours.nrows) == (ref.lo, ref.hi, ref.nrows)
    assert ours.idx.dtype == torch.int32
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    assert sorted(ours.payload) == sorted(ref.payload)
    for name, (vals, nulls, ptype) in ref.payload.items():
        tv, tn, tp = ours.payload[name]
        assert tp == ptype, name
        np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(nulls))
    assert ours.verified and ours.nbytes > 0
    assert tctx.cache.budget.memory_used >= ours.nbytes
    tfa.release_prep_cache(tctx._tables["orders"])
    assert not tctx._tables["orders"]._star_probe_cache
    assert tstar.MAX_DIM_SPAN == 1 << 27


def test_released_probe_drops_the_plans_that_pin_it(sessions):
    """A cached star plan holds its dimensions' tensors: releasing a
    table's builds gives their bytes back and drops those plans, and the
    next run builds and caches them again."""
    _, tctx = sessions
    sql = CASES[0][1]  # fact JOIN dim
    want = tctx.sql(sql).to_arrow()
    plans, dim = tctx._exec._star_plan_cache, tctx._tables["dim"]
    probes = list(dim._star_probe_cache.values())
    held = {ck for pb in probes for ck in pb.plans}
    assert probes and all(pb.cached for pb in probes)
    assert held & set(plans)
    used = tctx.cache.budget.memory_used
    tfa.release_prep_cache(dim)
    assert not held & set(plans)
    assert tctx.cache.budget.memory_used <= used - sum(pb.nbytes
                                                       for pb in probes)
    assert not any(pb.cached or pb.plans for pb in probes)
    _assert_same_answer(tctx.sql(sql).to_arrow(), want)
    assert any(pb.plans for pb in dim._star_probe_cache.values())


def test_uncharged_probe_leaves_its_plan_uncached(sessions, monkeypatch):
    """A dimension build the budget cannot hold is neither cached nor
    kept alive by a cached plan: every run builds it again, and the
    budget's count does not move."""
    _, tctx = sessions
    sql = CASES[0][1]
    want = tctx.sql(sql).to_arrow()
    dim, plans = tctx._tables["dim"], tctx._exec._star_plan_cache
    tfa.release_prep_cache(dim)
    n_plans, budget = len(plans), tctx.cache.budget
    used = budget.memory_used
    monkeypatch.setattr(budget, "try_reserve_memory", lambda nbytes: False)
    t0 = tfa.STATS["star_queries"]
    for _ in range(2):
        _assert_same_answer(tctx.sql(sql).to_arrow(), want)
        assert not dim._star_probe_cache and len(plans) == n_plans
    assert tfa.STATS["star_queries"] == t0 + 2
    assert budget.memory_used == used
