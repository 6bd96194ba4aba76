"""The port's classic path against the JAX package's, both on the CPU.

- `ops/groupby.group_reduce` and `ops/hashagg.hash_group_reduce_packed`:
  codes, NULL flags, counts and integer sums exact, float sums to rtol
  1e-9, a colliding table's `clean` flag and group count included.
- `DeviceGroupedAggregator` / `DeviceScalarAggregator` with COMPACT_ROWS
  lowered so the pre-reduction runs, and a key set that defeats the hash
  table (the retry, then the sort).
- `KeyCodec.encode` / `decode` round trips for every key kind, strings
  by their global vocabulary.
- `scan_blocks`: the same selected rows per block, zone and dynamic
  prunes counted alike, on `nano_hits` and a TPC-H table; the cache's
  batched masks (`eval_predicate_many`) bit for bit.
- SQL through both sessions: the classic-path shapes of
  `tests/test_sql_semantics.py`, correlated lookups (scalar, EXISTS with
  an `extra` residual), and K1's single form counted on the CPU by
  wrapping `bitpack_cuda.cmp_const_many`."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.bench import tpch_data as jtpch  # noqa: E402
from liquid_tpu.ops import groupby as jgb  # noqa: E402
from liquid_tpu.ops import hashagg as jha  # noqa: E402
from liquid_tpu.sql import device_agg as jda  # noqa: E402
from liquid_tpu.sql import physical as jphys  # noqa: E402
from liquid_tpu.sql import planner as jplan  # noqa: E402
from liquid_tpu.sql.parser import parse_statement as jparse  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench import tpch_data as ttpch  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda  # noqa: E402
from liquid_tpu_torch.ops import groupby as tgb  # noqa: E402
from liquid_tpu_torch.ops import hashagg as tha  # noqa: E402
from liquid_tpu_torch.sql import device_agg as tda  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql import physical as tphys  # noqa: E402
from liquid_tpu_torch.sql import planner as tplan  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_statement as tparse  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402


def _inputs(seed, n, card):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, card, n)
    n1 = rng.random(n) < 0.1
    c1 = np.where(n1, 0, c1)
    c2 = rng.integers(-2, 2, n)
    valid = rng.random(n) < 0.9
    vals = (rng.normal(size=n), rng.integers(-100, 100, n),
            rng.integers(-100, 100, n))
    vnulls = (rng.random(n) < 0.2, np.zeros(n, bool), rng.random(n) < 0.2)
    return ((c1, c2), (n1, np.zeros(n, bool)), valid, vals, vnulls,
            ("sum", "min", "max"))


def _both(args):
    codes, knulls, valid, vals, vnulls, kinds = args
    j = (tuple(jnp.asarray(c) for c in codes),
         tuple(jnp.asarray(c) for c in knulls), jnp.asarray(valid),
         tuple(jnp.asarray(v) for v in vals),
         tuple(jnp.asarray(v) for v in vnulls), kinds)
    t = (tuple(torch.tensor(c) for c in codes),
         tuple(torch.tensor(c) for c in knulls), torch.tensor(valid),
         tuple(torch.tensor(v) for v in vals),
         tuple(torch.tensor(v) for v in vnulls), kinds)
    return j, t


def _same_col(a, b, g):
    a, b = np.asarray(a)[:g], b.numpy()[:g]
    if a.dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-9)
    else:
        assert (a == b).all()


@pytest.mark.parametrize("seed,n,card", [(0, 3000, 50), (1, 5000, 6),
                                         (2, 1, 3)])
def test_group_reduce_matches_reference(seed, n, card):
    j, t = _both(_inputs(seed, n, card))
    jo, to = jgb.group_reduce(*j), tgb.group_reduce(*t)
    g = int(jo[0])
    assert g == int(to[0])
    for part in range(1, 5):
        for a, b in zip(jo[part], to[part]):
            _same_col(a, b, g)


@pytest.mark.parametrize("n_slots,salt,card", [
    (8192, 0x9E3779B97F4A7C15, 6),      # clean
    (64, 0xC2B2AE3D27D4EB4F, 50),       # dirty: collisions in 64 slots
    (1 << 14, 0xC2B2AE3D27D4EB4F, 40)])
def test_hash_group_reduce_packed_matches_reference(n_slots, salt, card):
    j, t = _both(_inputs(3, 4000, card))
    jm = np.asarray(jha.hash_group_reduce_packed(*j, n_slots, salt)[0])
    tm = tha.hash_group_reduce_packed(*t, n_slots, salt)[0].numpy()
    assert jm.shape == tm.shape
    assert (jm[0, :2] == tm[0, :2]).all()  # clean flag, group count
    if jm[0, 0]:
        assert (jm == tm).all()


def _slots(mod, specs):
    return [mod.AggSlot(None, f"__agg{i}", kind, None if kind == "count_star"
                        else object()) for i, kind in enumerate(specs)]


def _chunks(seed, n_chunks, rows, card):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(card)])
    for _ in range(n_chunks):
        k1 = pa.array(words[rng.integers(0, card, rows)],
                      mask=rng.random(rows) < 0.05)
        k2 = pa.array(rng.integers(0, 3, rows).astype(np.int32))
        x = pa.array(rng.integers(-50, 50, rows), mask=rng.random(rows) < 0.1)
        f = pa.array(rng.normal(size=rows))
        yield [k1, k2], x, f, rows


SPECS = ["count_star", "count", "sum", "avg", "min", "max", "var", "stddev"]


def _feed(agg, chunks, grouped=True):
    for keys, x, f, rows in chunks:
        inputs = {"__agg1": x, "__agg2": x, "__agg3": f, "__agg4": x,
                  "__agg5": f, "__agg6": f, "__agg7": x}
        if grouped:
            agg.update(keys, inputs, rows)
        else:
            agg.update(inputs, rows)


def _assert_tables(a: pa.Table, b: pa.Table, ordered: bool):
    assert a.column_names == b.column_names
    assert a.schema == b.schema
    ra, rb = a.to_pylist(), b.to_pylist()
    if not ordered:
        def key(r):
            return tuple((v is None, str(v)) for v in r.values())
        ra, rb = sorted(ra, key=key), sorted(rb, key=key)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        for c in x:
            if isinstance(x[c], float) and y[c] is not None:
                assert x[c] == pytest.approx(y[c], rel=1e-9, abs=1e-12)
            else:
                assert x[c] == y[c], c


@pytest.mark.parametrize("card,compact", [(40, 1 << 22), (40, 1000),
                                          (30000, 1 << 22)],
                         ids=["buffered", "compacted", "hash_defeated"])
def test_device_grouped_aggregator_matches_reference(card, compact,
                                                     monkeypatch):
    monkeypatch.setattr(jda.DeviceGroupedAggregator, "COMPACT_ROWS", compact)
    monkeypatch.setattr(tda.DeviceGroupedAggregator, "COMPACT_ROWS", compact)
    ja = jda.DeviceGroupedAggregator(["k1", "k2"], _slots(jphys, SPECS))
    ta = tda.DeviceGroupedAggregator(["k1", "k2"], _slots(tphys, SPECS),
                                     "cpu")
    jf, tf = jda.STATS["hash_agg_fallbacks"], tda.STATS["hash_agg_fallbacks"]
    _feed(ja, _chunks(5, 4, 3000, card))
    _feed(ta, _chunks(5, 4, 3000, card))
    # same hashing: the same table size, collisions and row order
    _assert_tables(ta.finalize(), ja.finalize(), ordered=True)
    assert (tda.STATS["hash_agg_fallbacks"] - tf
            == jda.STATS["hash_agg_fallbacks"] - jf)
    if card > 10000:
        assert tda.STATS["hash_agg_fallbacks"] > tf


def test_device_scalar_aggregator_matches_reference():
    ja = jda.DeviceScalarAggregator(_slots(jphys, SPECS))
    ta = tda.DeviceScalarAggregator(_slots(tphys, SPECS), "cpu")
    _feed(ja, _chunks(6, 3, 2000, 10), grouped=False)
    _feed(ta, _chunks(6, 3, 2000, 10), grouped=False)
    types = {"__agg2": pa.int64(), "__agg4": pa.int64(),
             "__agg5": pa.float64()}
    _assert_tables(ta.finalize(types), ja.finalize(types), ordered=True)


CODEC_CASES = {
    "int": pa.array([3, None, -7, 3], pa.int32()),
    "uint64": pa.array([2 ** 64 - 1, 0, None], pa.uint64()),
    "float": pa.array([1.5, -0.0, float("nan"), None, 0.0]),
    "date32": pa.array([0, 19000, None], pa.date32()),
    "timestamp": pa.array([0, 10 ** 12, None], pa.timestamp("ms")),
    "bool": pa.array([True, None, False]),
    "string": pa.array(["b", None, "a", "b"]),
    "dict": pa.array(["x", "y", None, "x"]).dictionary_encode(),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_key_codec_round_trip(case):
    arr = CODEC_CASES[case]
    jc, tc = jda.KeyCodec(arr.type), tda.KeyCodec(arr.type)
    jcodes, jnulls = jc.encode(arr)
    tcodes, tnulls = tc.encode(arr)
    assert (jcodes == tcodes).all() and (jnulls == tnulls).all()
    plain = arr.cast(arr.type.value_type) if case == "dict" else arr
    back = tc.decode(tcodes, tnulls)
    if case == "float":  # -0.0 codes as +0.0, NaN stays NaN
        assert [v if v == v else "nan" for v in back.to_pylist()] == \
            [1.5, 0.0, "nan", None, 0.0]
    else:
        assert back.to_pylist() == plain.to_pylist()
    assert back.type == plain.type


def test_string_codes_grow_one_vocabulary():
    tc = tda.KeyCodec(pa.string())
    a, _ = tc.encode(pa.array(["p", "q", "p"]))
    b, _ = tc.encode(pa.array(["r", "q"]))
    assert a.tolist() == [0, 1, 0] and b.tolist() == [2, 1]


@pytest.fixture(scope="module")
def tpch_sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_classic")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for side, gen, ctx in (("j", jtpch, jctx), ("t", ttpch, tctx)):
        for name, t in gen.generate(0.01).items():
            if name not in ("lineitem", "part", "partsupp", "supplier"):
                continue
            path = str(d / f"{side}_{name}.parquet")
            pq.write_table(t, path, row_group_size=1 << 14)
            ctx.register_parquet(name, path)
    for ctx in (jctx, tctx):
        ctx.register_parquet("hits", NANO_HITS)
    return jctx, tctx


SCANS = [
    ("hits", 'SELECT 1 FROM hits WHERE "UserID" = 435090932899640449',
     ["UserID"]),
    ("hits", 'SELECT 1 FROM hits WHERE "AdvEngineID" <> 0 AND '
     '"ResolutionWidth" > 1000', ["AdvEngineID", "ResolutionWidth"]),
    ("hits", 'SELECT 1 FROM hits WHERE "URL" LIKE \'%google%\'', ["URL"]),
    ("lineitem", "SELECT 1 FROM lineitem WHERE l_quantity < 10 AND "
     "l_discount >= 0.05 AND l_shipdate >= date '1995-01-01'",
     ["l_quantity", "l_orderkey"]),
    ("lineitem", "SELECT 1 FROM lineitem WHERE l_suppkey BETWEEN 10 AND 20 "
     "OR l_partkey = 7", ["l_suppkey", "l_extendedprice"]),
]


def _scan(mod, plan_mod, parse, ctx, table, sql, need, dynamic=None):
    t = ctx._tables[table]
    q = parse(sql)[1]
    plan = plan_mod.plan_scan_filters(q.where)
    z0 = t.zone_prunes
    d0 = t.cache.observer.stats.get("dynamic_filter_prunes")
    out = [(b.rg, b.batch, b.sel_idx.tolist(),
            [b.col(c).to_pylist() for c in need])
           for b in mod.scan_blocks(t, plan, {}, need, dynamic=dynamic)]
    return (out, t.zone_prunes - z0,
            t.cache.observer.stats.get("dynamic_filter_prunes") - d0)


@pytest.mark.parametrize("i", range(len(SCANS)))
def test_scan_blocks_selects_the_reference_rows(tpch_sessions, i):
    """The same blocks and rows.  Zone prunes count alike where both
    packages record the zone maps on first load (the TPC-H files); the
    reference seeds `nano_hits`'s from its page index, which the port
    does not read yet (ROADMAP Queue 1 item 6), so there only the rows
    compare."""
    jctx, tctx = tpch_sessions
    table, sql, need = SCANS[i]
    for _ in range(2):  # the second pass reads the zone maps of the first
        got = _scan(tphys, tplan, tparse, tctx, table, sql, need)
        want = _scan(jphys, jplan, jparse, jctx, table, sql, need)
        assert got[0] == want[0]
        assert got[2] == want[2]
        if table != "hits":
            assert got[1] == want[1]


def test_scan_blocks_dynamic_filter_prunes_alike(tpch_sessions):
    """A runtime filter (a top-k threshold) prunes the same blocks."""
    jctx, tctx = tpch_sessions

    def dyn(mod):
        return lambda: (("l_orderkey",
                         mod.Predicate("lt_eq", 3000)),)

    from liquid_tpu.arrays import base as jbase
    from liquid_tpu_torch.arrays import base as tbase
    sql = "SELECT 1 FROM lineitem WHERE l_quantity > 5"
    got = _scan(tphys, tplan, tparse, tctx, "lineitem", sql, ["l_orderkey"],
                dyn(tbase))
    want = _scan(jphys, jplan, jparse, jctx, "lineitem", sql, ["l_orderkey"],
                 dyn(jbase))
    assert got == want and got[2] > 0


@pytest.mark.parametrize("col,op,lit", [
    ("l_quantity", "lt", 10), ("l_suppkey", "eq", 3),
    ("l_discount", "gt_eq", 0.05), ("l_partkey", "ne", 100),
    ("l_shipmode", "eq", "MAIL")])
def test_eval_predicate_many_masks_bit_for_bit(tpch_sessions, col, op, lit):
    from liquid_tpu.arrays.base import Predicate as JPred
    from liquid_tpu_torch.arrays.base import Predicate as TPred
    from liquid_tpu_torch.device import words_to_numpy
    jctx, tctx = tpch_sessions
    jt, tt = jctx._tables["lineitem"], tctx._tables["lineitem"]
    for rg in range(tt.num_row_groups):
        jm = jt.eval_predicate_many(rg, col, JPred(op, lit))
        tm = tt.eval_predicate_many(rg, col, TPred(op, lit))
        assert sorted(jm) == sorted(tm)
        for b in jm:
            assert (jm[b] is None) == (tm[b] is None)
            if jm[b] is None:
                continue
            assert (np.asarray(jm[b].bits)
                    == words_to_numpy(tm[b].bits)).all()
            assert (np.asarray(jm[b].valid)
                    == words_to_numpy(tm[b].valid)).all()


def test_classic_scan_launches_k1_once_per_bucket(tpch_sessions,
                                                  monkeypatch):
    """Each (row group, predicate, width bucket) with two or more blocks
    is one call of K1's single form; counted on the CPU by wrapping the
    wrapper."""
    _, tctx = tpch_sessions
    calls = []
    real = bitpack_cuda.cmp_const_many

    def counting(planes, cs):
        calls.append(tuple(planes.shape))
        return real(planes, cs)

    monkeypatch.setattr(bitpack_cuda, "cmp_const_many", counting)
    t = tctx._tables["lineitem"]
    q = tparse("SELECT 1 FROM lineitem WHERE l_suppkey < 50")[1]
    blocks = list(tphys.scan_blocks(t, tplan.plan_scan_filters(q.where), {},
                                    ["l_suppkey"]))
    assert blocks
    buckets = {}
    cache = t.cache
    for rg in range(t.num_row_groups):
        for eid in t.ensure_cached(rg, "l_suppkey"):
            p = cache._entries[eid].payload
            if p.packed_plan(tphys.Predicate("lt", 50))[0] == "cmp":
                buckets[(rg, p.planes_np.shape[0])] = buckets.get(
                    (rg, p.planes_np.shape[0]), 0) + 1
    assert len(calls) == sum(1 for n in buckets.values() if n >= 2) > 0


@pytest.fixture()
def sem_sessions(tmp_path):
    t = pa.table({"id": pa.array([1, 2, 3, 4, 5], pa.int64()),
                  "x": pa.array([10, None, 30, None, 50], pa.int64()),
                  "s": pa.array(["a", "b", None, "d", "e"], pa.string())})
    u = pa.table({"uid": pa.array([1, 2, None, 4], pa.int64()),
                  "w": pa.array([100, 200, 300, 400], pa.int64())})
    pq.write_table(t, str(tmp_path / "t.parquet"))
    pq.write_table(u, str(tmp_path / "u.parquet"))
    jctx, _ = JBuilder().build()
    tctx, _ = LiquidCacheLocalBuilder(device="cpu").build()
    for ctx in (jctx, tctx):
        ctx.register_parquet("t", str(tmp_path / "t.parquet"))
        ctx.register_parquet("u", str(tmp_path / "u.parquet"))
    return jctx, tctx


#: (case, sql, ordered): shapes of tests/test_sql_semantics.py that run
#: the classic path in both packages
SEMANTICS = [
    ("join_null_keys", "select id, w from t, u where id = uid order by id",
     True),
    ("left_join_unmatched",
     "select id, w from t left join u on id = uid order by id", True),
    ("right_join", "select id, uid, w from t right join u on id = uid",
     False),
    ("full_join", "select id, uid from t full join u on id = uid", False),
    ("not_in_null_subquery",
     "select id from t where id not in (select uid from u)", False),
    ("in_subquery", "select id from t where id in (select uid from u) "
     "order by id", True),
    # median has no fused form: these run the classic aggregators
    ("empty_aggregates", "select count(*) as c, sum(x) as s, min(x) as m, "
     "median(x) as md from t where id > 100", True),
    ("empty_group_by", "select x, count(*) as c, median(id) as md from t "
     "where id > 100 group by x", False),
    ("distinct_nulls", "select distinct x from t", False),
    ("median_stddev", "select id % 2 as g, var(id) as vr, median(id) as md "
     "from t group by g order by g", True),
    ("derived_self_join", "select lo.id, hi.id big from (select * from t "
     "where id <= 2) lo, (select * from t where id >= 4) hi where lo.id + 3 "
     "= hi.id order by lo.id", True),
    ("scalar_in_select", "select id, (select max(w) from u) m from t "
     "order by id", True),
]


@pytest.mark.parametrize("case,sql,ordered", SEMANTICS,
                         ids=[c[0] for c in SEMANTICS])
def test_semantics_through_both_sessions(sem_sessions, case, sql, ordered):
    jctx, tctx = sem_sessions
    before = dict(texec.STATS)
    _assert_tables(tctx.sql(sql).to_arrow(), jctx.sql(sql).to_arrow(),
                   ordered)
    assert texec.STATS != before, "the classic path did not run"


CORRELATED = [
    ("scalar_lookup", "select id, x from t where x > (select avg(w) / 10 "
     "from u where uid = id) - 15 order by id"),
    ("scalar_lookup_no_match", "select id from t where (select max(w) "
     "from u where uid = id) is null order by id"),
    ("exists_with_extra", "select id from t where exists (select * from u "
     "where uid = id and w > x * 5) order by id"),
    ("not_exists_with_extra", "select id from t where not exists (select * "
     "from u where uid = id and w < x * 20) order by id"),
]


@pytest.mark.parametrize("case,sql", CORRELATED,
                         ids=[c[0] for c in CORRELATED])
def test_correlated_lookups(sem_sessions, case, sql):
    jctx, tctx = sem_sessions
    _assert_tables(tctx.sql(sql).to_arrow(), jctx.sql(sql).to_arrow(), True)


def test_classic_routes_are_counted(sem_sessions):
    """A fused refusal hands the query to the classic path: the fused
    counters say why, the executor's say where it went."""
    _, tctx = sem_sessions
    b0, e0 = tfa.STATS["fused_bailouts"], dict(texec.STATS)
    tctx.sql("select x, median(id) from t group by x").to_arrow()
    assert tfa.STATS["fused_bailouts"] == b0 + 1
    assert texec.STATS["classic_aggregates"] == e0["classic_aggregates"] + 1
    s0 = tfa.STATS["select_bailouts"]
    tctx.sql("select * from t order by id limit 2").to_arrow()
    assert tfa.STATS["select_bailouts"] == s0 + 1
    assert texec.STATS["classic_selects"] == e0["classic_selects"] + 1
    j0 = texec.STATS["classic_joins"]
    tctx.sql("select id, w from t left join u on id = uid").to_arrow()
    assert texec.STATS["classic_joins"] == j0 + 1
