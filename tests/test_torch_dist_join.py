"""Distributed joins on a mesh of eight CPU shards (`liquid_tpu_torch/
parallel/join.py`), and the three query sets at small scale.

- The join shapes of `tests/test_dist_join.py` (a q3-shaped pipeline, a
  scalar join aggregate, non-unique build keys, pathological skew, NULL
  keys, multi-key equi-joins) against pyarrow's `Table.join` and
  `group_by` on the same tables (the reference's shard_map compile costs
  tens of seconds per join shape).
- Three defects of the reference the port does not copy (ADVICE.md:3,
  5, 7), against pyarrow: a table in two composite-key pairs, a first
  table whose composite key joins second, and an ORDER BY on a grouped
  expression that is not a select item.
- TPC-H's distributed set at SF 0.005 against `bench/oracle.py` and
  TPC-DS's (`DIST_TPCDS_SUPPORTED`) at SF 0.005 against the reference's
  pandas oracles (`liquid_tpu.bench.tpcds_ref`), each set pinned
  grow-only and every query counted distributed.

Integers exact; floats rtol 1e-9."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import datetime  # noqa: E402

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.bench import oracle, tpcds_data, tpcds_queries  # noqa: E402
from liquid_tpu_torch.bench import tpch_data, tpch_queries  # noqa: E402
from liquid_tpu_torch.parallel import dist, make_mesh  # noqa: E402
from liquid_tpu_torch.parallel.session import (  # noqa: E402
    DIST_TPCDS_SUPPORTED, DistributedSession)

#: TPC-H queries that must run distributed -- grow-only (the reference's
#: `tests/test_dist_fallback.py::EXPECT_DISTRIBUTED`)
EXPECT_DISTRIBUTED_TPCH = {1, 3, 5, 6, 9, 10, 11, 12, 14, 15, 16, 18, 19}
#: TPC-DS queries that must run distributed -- grow-only
EXPECT_DISTRIBUTED_TPCDS = set(DIST_TPCDS_SUPPORTED)

SF = 0.005


@pytest.fixture
def strict(monkeypatch):
    monkeypatch.setenv("LIQUID_DIST_STRICT", "1")


def _sess(**tables) -> DistributedSession:
    s = DistributedSession(make_mesh(devices=["cpu"] * 8))
    for name, t in tables.items():
        s.register_table(name, t)
    return s


@pytest.fixture(scope="module")
def jtables():
    rng = np.random.default_rng(17)
    n_c, n_o, n_l = 500, 4_000, 12_007
    cust = pa.table({
        "c_custkey": np.arange(n_c, dtype=np.int64),
        "c_mktsegment": rng.choice(["BUILDING", "AUTOMOBILE", "MACHINERY"],
                                   n_c)})
    orders = pa.table({
        "o_orderkey": np.arange(n_o, dtype=np.int64),
        "o_custkey": rng.integers(0, n_c, n_o).astype(np.int64),
        "o_orderdate": (np.datetime64("1995-01-01") + rng.integers(
            0, 120, n_o).astype("timedelta64[D]")).astype("datetime64[D]")})
    line = pa.table({
        "l_orderkey": rng.integers(0, n_o, n_l).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(10, 1000, n_l), 2),
        "l_quantity": rng.integers(1, 50, n_l).astype(np.int64)})
    return {"customer": cust, "orders": orders, "lineitem": line}


@pytest.fixture(scope="module")
def jsess(jtables):
    return _sess(**jtables)


def _day(*ymd):
    return pa.scalar(datetime.date(*ymd))


def test_join_groupby_q3_shape(jtables, jsess, strict):
    out = jsess.sql(
        "select o_custkey, count(*) as c, sum(l_extendedprice) as rev "
        "from lineitem join orders on l_orderkey = o_orderkey "
        "join customer on o_custkey = c_custkey "
        "where c_mktsegment = 'BUILDING' "
        "and o_orderdate < date '1995-03-15' and l_quantity > 10 "
        "group by o_custkey order by rev desc limit 10")
    li, o, c = jtables["lineitem"], jtables["orders"], jtables["customer"]
    m = li.filter(pc.greater(li["l_quantity"], 10)).join(
        o.filter(pc.less(o["o_orderdate"], _day(1995, 3, 15))),
        "l_orderkey", "o_orderkey", join_type="inner")
    m = m.join(c.filter(pc.equal(c["c_mktsegment"], "BUILDING")),
               "o_custkey", "c_custkey", join_type="inner")
    g = m.group_by("o_custkey").aggregate([
        ("l_extendedprice", "count"), ("l_extendedprice", "sum")]).sort_by(
            [("l_extendedprice_sum", "descending")]).slice(0, 10)
    assert oracle.same_table(out, [g["o_custkey"], g["l_extendedprice_count"],
                                   g["l_extendedprice_sum"]])


def test_join_scalar_agg(jtables, jsess, strict):
    out = jsess.sql(
        "select count(*) as c, sum(l_quantity) as q, min(l_quantity) as lo, "
        "max(l_quantity) as hi from lineitem join orders "
        "on l_orderkey = o_orderkey where o_orderdate >= date '1995-03-01'")
    o = jtables["orders"]
    m = jtables["lineitem"].join(
        o.filter(pc.greater_equal(o["o_orderdate"], _day(1995, 3, 1))),
        "l_orderkey", "o_orderkey", join_type="inner")
    q = m["l_quantity"]
    assert out.to_pylist() == [{"c": m.num_rows, "q": pc.sum(q).as_py(),
                                "lo": pc.min(q).as_py(),
                                "hi": pc.max(q).as_py()}]


def test_nonunique_build_keys_skew_and_nulls(strict):
    s = _sess(
        ja=pa.table({"ak": pa.array([1, 2, 2, 3], pa.int64()),
                     "av": pa.array([10, 20, 21, 30], pa.int64())}),
        jb=pa.table({"bk": pa.array([2, 2, 2, 3, 4], pa.int64()),
                     "bv": pa.array([1, 2, 3, 4, 5], pa.int64())}),
        na=pa.table({"k": pa.array([1, None, 2, 2], pa.int64()),
                     "v": pa.array([5, 6, None, 8], pa.int64())}),
        nb=pa.table({"k2": pa.array([1, 2, None], pa.int64()),
                     "w": pa.array([100, 200, 300], pa.int64())}))
    # one output row per match
    assert s.sql("select count(*) as c, sum(bv) as sv from ja join jb "
                 "on ak = bk").to_pylist() == [{"c": 7, "sv": 16}]
    # NULL keys match nothing; NULL payloads skip aggregation
    assert s.sql("select count(*) as c, count(v) as cv, sum(w) as sw "
                 "from na join nb on k = k2").to_pylist() == [
        {"c": 3, "cv": 2, "sw": 500}]
    # pathological skew: 80 % of the probe rows on one key; the
    # exchange's capacity is measured, so no row is lost
    rng = np.random.default_rng(23)
    n = 20_000
    keys = rng.integers(0, 50, n).astype(np.int64)
    keys[: int(n * 0.8)] = 7
    fact = pa.table({"fk": keys, "fv": np.ones(n, np.int64)})
    dim = pa.table({"dk": np.arange(50, dtype=np.int64),
                    "dv": np.arange(50, dtype=np.int64) * 100})
    s.register_table("skf", fact)
    s.register_table("skd", dim)
    out = s.sql("select dk, count(*) as c, sum(dv) as sv from skf "
                "join skd on fk = dk group by dk order by dk")
    g = fact.join(dim, "fk", "dk", join_type="inner").group_by("fk").aggregate([
        ("dv", "count"), ("dv", "sum")]).sort_by("fk")
    assert oracle.same_table(out, [g["fk"], g["dv_count"], g["dv_sum"]])
    assert dist.DIAG["exchange_overflow"] == 0
    assert dist.DIAG["exchange_balance"] > 2  # the skew is seen


def test_multi_key_equi_joins(strict):
    s = _sess(
        mk1=pa.table({"a": pa.array([1, 1, 2, 2], pa.int64()),
                      "b": pa.array([10, 20, 10, 20], pa.int64()),
                      "v": [1.0, 2.0, 3.0, 4.0]}),
        mk2=pa.table({"c": pa.array([1, 1, 2, 2], pa.int64()),
                      "d": pa.array([10, 20, 10, 20], pa.int64())}),
        mkn1=pa.table({"a1": pa.array([1, 1], pa.int64()),
                       "b1": pa.array([10, None], pa.int64())}),
        mkn2=pa.table({"c1": pa.array([1, 1], pa.int64()),
                       "d1": pa.array([10, None], pa.int64())}))
    assert s.sql("select count(*) as n, sum(v) as sv from mk1, mk2 "
                 "where a = c and b = d").to_pylist() == [{"n": 4,
                                                           "sv": 10.0}]
    assert s.sql("select count(*) as n from mk1 join mk2 on a = c and "
                 "b = d").to_pylist() == [{"n": 4}]
    assert s.sql("select count(*) as n from mk1, mk2 where a = c"
                 ).to_pylist() == [{"n": 8}]
    # NULL = NULL is no match
    assert s.sql("select count(*) as n from mkn1, mkn2 where a1 = c1 and "
                 "b1 = d1").to_pylist() == [{"n": 1}]


# -- ADVICE.md: the reference's join defects, held to pyarrow -------------------------

def _composite_tables(rng):
    n = 400
    t1 = pa.table({"a": rng.integers(0, 5, n), "b": rng.integers(0, 7, n),
                   "x": rng.integers(0, 4, n), "y": rng.integers(0, 6, n),
                   "k": rng.integers(0, 9, n), "v": rng.integers(0, 100, n)})
    t2 = pa.table({"a2": np.repeat(np.arange(5), 7),
                   "b2": np.tile(np.arange(7), 5),
                   "w2": np.arange(35)})
    t3 = pa.table({"x3": np.repeat(np.arange(4), 6),
                   "y3": np.tile(np.arange(6), 4),
                   "w3": np.arange(24) * 10})
    t4 = pa.table({"k4": np.arange(9), "w4": np.arange(9) * 3})
    return t1, t2, t3, t4


def test_table_in_two_composite_pairs(strict):
    """ADVICE.md:3: the reference names both packed keys `__jk_t1`."""
    t1, t2, t3, _t4 = _composite_tables(np.random.default_rng(30))
    s = _sess(t1=t1, t2=t2, t3=t3)
    out = s.sql("select count(*) as n, sum(v) as sv, sum(w2) as s2, "
                "sum(w3) as s3 from t1, t2, t3 where a = a2 and b = b2 "
                "and x = x3 and y = y3")
    j = t1.join(t2, ["a", "b"], ["a2", "b2"], join_type="inner").join(
        t3, ["x", "y"], ["x3", "y3"], join_type="inner")
    assert out.to_pylist() == [{
        "n": j.num_rows, "sv": pc.sum(j["v"]).as_py(),
        "s2": pc.sum(j["w2"]).as_py(), "s3": pc.sum(j["w3"]).as_py()}]


def test_first_table_keeps_its_synthetic_key(strict):
    """ADVICE.md:5: `ja` is first and in a composite pair with `zz`, but
    its single-key edge to `jc` joins first."""
    t1, t2, _t3, t4 = _composite_tables(np.random.default_rng(31))
    s = _sess(ja=t1, zz=t2, jc=t4)
    out = s.sql("select count(*) as n, sum(w2) as s2, sum(w4) as s4 "
                "from ja, zz, jc where k = k4 and a = a2 and b = b2")
    j = t1.join(t4, "k", "k4", join_type="inner").join(
        t2, ["a", "b"], ["a2", "b2"], join_type="inner")
    assert out.to_pylist() == [{"n": j.num_rows,
                                "s2": pc.sum(j["w2"]).as_py(),
                                "s4": pc.sum(j["w4"]).as_py()}]


def test_order_by_grouped_expression_not_selected(jtables, jsess, strict):
    """ADVICE.md:7: ORDER BY an expression key that no item selects."""
    out = jsess.sql(
        "select count(*) as c, sum(l_quantity) as q from lineitem "
        "join orders on l_orderkey = o_orderkey "
        "group by extract(month from o_orderdate) "
        "order by extract(month from o_orderdate) desc")
    o = jtables["orders"]
    m = jtables["lineitem"].join(o, "l_orderkey", "o_orderkey",
                                 join_type="inner")
    g = pa.table({"m": pc.month(m["o_orderdate"]),
                  "q": m["l_quantity"]}).group_by("m").aggregate([
                      ("q", "count"), ("q", "sum")]).sort_by(
                          [("m", "descending")])
    assert out.column_names == ["c", "q"]
    assert out.to_pylist() == [{"c": r["q_count"], "q": r["q_sum"]}
                               for r in g.to_pylist()]


# -- the three query sets at small scale -------------------------------------------------

@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_tpch")
    s = DistributedSession(make_mesh(devices=["cpu"] * 8))
    paths = {}
    for name, t in tpch_data.generate(SF).items():
        paths[name] = str(d / f"{name}.parquet")
        pq.write_table(t, paths[name])
        s.register_table(name, t)
    return s, paths


@pytest.mark.parametrize("qid", sorted(oracle.DIST_TPCH))
def test_tpch_distributed(tpch, qid, strict):
    s, paths = tpch
    key = oracle.DIST_TPCH[qid]
    d0 = s.route_stats["distributed"]
    got = s.sql(tpch_queries.QUERIES[qid])
    stmts = tpch_queries.QUERIES[qid]
    stmts = len(stmts) if isinstance(stmts, list) else 1
    if qid in EXPECT_DISTRIBUTED_TPCH:
        assert s.route_stats["distributed"] == d0 + stmts
    assert oracle.same_table(got, oracle.answers(paths, [key])[key],
                             oracle.CUTS.get(key))


def test_tpch_set_is_pinned():
    assert EXPECT_DISTRIBUTED_TPCH <= set(oracle.DIST_TPCH)
    assert len(EXPECT_DISTRIBUTED_TPCH) >= 13


@pytest.fixture(scope="module")
def tpcds():
    from liquid_tpu.bench import tpcds_ref
    tables = tpcds_data.generate(SF)
    s = DistributedSession(make_mesh(devices=["cpu"] * 8))
    for name, t in tables.items():
        s.register_table(name, t)
    return s, tpcds_ref, tpcds_ref.to_pandas_tables(tables)


@pytest.mark.parametrize("qid", DIST_TPCDS_SUPPORTED)
def test_tpcds_distributed(tpcds, qid, strict):
    s, tpcds_ref, pdt = tpcds
    d0 = s.route_stats["distributed"]
    got = s.sql(tpcds_queries.QUERIES[qid])
    if qid in EXPECT_DISTRIBUTED_TPCDS:
        assert s.route_stats["distributed"] == d0 + 1
    ref = tpcds_ref.REFS[qid](pdt).reset_index(drop=True)
    assert got.num_rows == len(ref)
    for col, name in zip(got.columns, ref.columns):
        want = ref[name].to_numpy()
        if pa.types.is_floating(col.type) or want.dtype.kind == "f":
            g = np.asarray(col.to_numpy(zero_copy_only=False), float)
            w = np.asarray(want, float)
            assert np.allclose(g, w, rtol=1e-9, equal_nan=True), (qid, name)
        else:
            assert [str(x) for x in col.to_pylist()] == \
                [str(x) for x in want], (qid, name)
