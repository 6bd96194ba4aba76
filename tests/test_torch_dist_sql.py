"""Distributed SQL on a mesh of eight CPU shards (`liquid_tpu_torch/parallel/
session.py`), single-table shapes.

- Three shapes of `tests/test_dist_sql.py` (a filtered count and sum, an
  int GROUP BY with min / max, a string GROUP BY with avg) against the
  reference's `DistributedSession` on its 8-device virtual mesh; the
  rest of that file's shapes against pyarrow on the same table (the
  reference's shard_map compile costs seconds per query shape).
- ClickBench's distributed set (the reference's
  `tests/test_dist_clickbench.py::EXPECT_DISTRIBUTED_CB`, pinned
  grow-only) on `nano_hits.parquet` against the port's single-device
  session, under the tie rule of a LIMIT cut (`oracle.same_table`).
- The route to the single-device engine: only `MeshUnsupported` takes it
  (answered and counted); any other error propagates.
- A string NOT IN subquery whose result holds a NULL keeps no row
  (ADVICE.md:4; the reference keeps rows), against pyarrow.

Integers exact; floats rtol 1e-9."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import datetime  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.bench import oracle  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.parallel import dist, make_mesh  # noqa: E402
from liquid_tpu_torch.parallel.session import DistributedSession  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

#: ClickBench queries that must run distributed -- grow-only
EXPECT_DISTRIBUTED_CB = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                         14, 15, 16, 17, 29, 30, 31, 32, 33}


@pytest.fixture
def strict(monkeypatch):
    monkeypatch.setenv("LIQUID_DIST_STRICT", "1")


def _mesh():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def events():
    rng = np.random.default_rng(3)
    n = 20_003  # not a multiple of 32 x 8: padding rows
    return pa.table({
        "region": pa.array(rng.integers(0, 50, n).astype(np.int64)),
        "status": pa.array(rng.choice(["ok", "warn", "err"], n)),
        "qty": pa.array(rng.integers(1, 100, n).astype(np.int64)),
        "price": pa.array(np.round(rng.random(n) * 100, 2)),
        "day": pa.array((np.datetime64("2024-01-01")
                         + rng.integers(0, 365, n).astype("timedelta64[D]")
                         ).astype("datetime64[D]")),
    })


@pytest.fixture(scope="module")
def dsess(events):
    s = DistributedSession(_mesh())
    s.register_table("events", events)
    return s


def _close(got: pa.Table, want: pa.Table) -> bool:
    return oracle.same_table(got, want.columns)


REF_SHAPES = [
    "select count(*) as c, sum(qty) as s from events where qty > 50",
    "select region, count(*) as c, sum(qty) as s, min(qty) as lo, "
    "max(qty) as hi from events where qty >= 10 group by region "
    "order by region",
    "select status, count(*) as c, avg(price) as p from events "
    "where region < 25 group by status order by status",
]


def test_shapes_match_reference_session(events, dsess, strict):
    from liquid_tpu.parallel.session import DistributedSession as JSession
    ref = JSession()
    ref.register_table("events", events)
    for sql in REF_SHAPES:
        want = ref.sql(sql)
        assert ref.route_stats["fallback"] == 0
        got = dsess.sql(sql)
        assert got.column_names == want.column_names
        assert _close(got, want), sql


def _filter(t: pa.Table, mask) -> pa.Table:
    return t.filter(mask)


def test_string_predicate_and_date(events, dsess, strict):
    got = dsess.sql("select count(*) as c from events where status = 'err' "
                    "and day >= date '2024-06-01'")
    m = pc.and_(pc.equal(events["status"], "err"),
                pc.greater_equal(events["day"],
                                 pa.scalar(datetime.date(2024, 6, 1))))
    assert got["c"].to_pylist() == [pc.sum(m).as_py()]


def test_float_sum(events, dsess, strict):
    got = dsess.sql("select sum(price) as s from events where price > 90")
    want = pc.sum(_filter(events, pc.greater(events["price"], 90))["price"])
    assert np.isclose(got["s"][0].as_py(), want.as_py(), rtol=1e-9)


def test_order_limit_padding_and_empty_groups(events, dsess, strict):
    got = dsess.sql("select region, sum(qty) as s from events "
                    "group by region order by s desc limit 5")
    g = events.group_by("region").aggregate([("qty", "sum")]).sort_by(
        [("qty_sum", "descending")])
    assert got["s"].to_pylist() == g["qty_sum"].to_pylist()[:5]
    # no WHERE: padding rows must not count
    assert dsess.sql("select count(*) as c from events")["c"].to_pylist() \
        == [events.num_rows]
    got = dsess.sql("select region, count(*) as c from events "
                    "where qty > 98 group by region")
    want = set(_filter(events, pc.greater(events["qty"], 98))["region"]
               .to_pylist())
    assert set(got["region"].to_pylist()) == want


def test_big_int64_literal_and_fractional_literals(events, dsess, strict):
    big = 4350909328992872310
    dsess.register_table("bigids", pa.table({
        "uid": pa.array([big, big + 1, big + 2], pa.int64()),
        "v": pa.array([1, 2, 3], pa.int64())}))
    assert dsess.sql(f"select count(*) as c from bigids where uid = "
                     f"{big + 1}")["c"].to_pylist() == [1]
    qty = events["qty"].to_numpy()
    assert dsess.sql("select count(*) as c from events where qty < 50.5"
                     )["c"].to_pylist() == [int((qty <= 50).sum())]
    assert dsess.sql("select count(*) as c from events where qty = 50.5"
                     )["c"].to_pylist() == [0]


def test_null_columns(dsess, strict):
    dsess.register_table("nully", pa.table({
        "k": pa.array([1, 1, None, 2, None, 2], pa.int64()),
        "v": pa.array([10, None, 5, 7, None, None], pa.int64())}))
    out = dsess.sql("select k, count(*) as c, count(v) as cv, sum(v) as s "
                    "from nully group by k order by k")
    assert out.to_pylist() == [
        {"k": 1, "c": 2, "cv": 1, "s": 10}, {"k": 2, "c": 2, "cv": 1, "s": 7},
        {"k": None, "c": 2, "cv": 1, "s": 5}]
    assert dsess.sql("select count(*) as c from nully where v >= 0"
                     )["c"].to_pylist() == [3]
    m = dsess.sql("select k, min(v) as lo, max(v) as hi from nully "
                  "group by k order by k")
    assert m["lo"].to_pylist() == [10, 7, 5]
    # min / max skip NULLs; a group whose inputs are all NULL gives NULL
    m = dsess.sql("select k, min(v) as lo, max(v) as hi from nully "
                  "where k = 2 group by k")
    assert m.to_pylist() == [{"k": 2, "lo": 7, "hi": 7}]
    m = dsess.sql("select min(v) as lo, sum(v) as s, count(v) as c "
                  "from nully where v > 10")
    assert m.to_pylist() == [{"lo": None, "s": None, "c": 0}]


def test_encoded_shard_bytes(events, dsess, strict):
    dt = dsess.tables["events"]
    qty = dt.columns["qty"]
    assert qty.kind == "planes" and qty.width == 7
    assert [tuple(p.shape) for p in qty.planes] == \
        [(8, dt.padded // 32 // 8)] * 8
    raw_bytes = dt.padded * 8
    assert qty.device_bytes() == raw_bytes * 8 // 64
    dsess.sql("select count(*) as c from events where qty > 50")
    assert dsess.last_scan_bytes == qty.device_bytes()


def test_multi_key_and_high_cardinality_group_by(events, dsess, strict):
    got = dsess.sql("select region, status, count(*) as c, sum(qty) as sq "
                    "from events where qty < 90 group by region, status "
                    "order by region, status")
    f = _filter(events, pc.less(events["qty"], 90))
    want = f.group_by(["region", "status"]).aggregate([
        ("qty", "count"), ("qty", "sum")]).sort_by(
            [("region", "ascending"), ("status", "ascending")])
    assert got.to_pylist() == [
        {"region": r["region"], "status": r["status"], "c": r["qty_count"],
         "sq": r["qty_sum"]} for r in want.to_pylist()]
    # past the first hash stage: the salted retry
    rng = np.random.default_rng(11)
    n = 40_000
    keys = rng.integers(0, 1 << 60, n).astype(np.int64)
    keys[: n // 2] = keys[: n // 2] // 2 * 2
    dsess.register_table("hc", pa.table({"k": keys,
                                         "v": np.ones(n, np.int64)}))
    got = dsess.sql("select k, sum(v) as s from hc group by k")
    uniq, counts = np.unique(keys, return_counts=True)
    assert dict(zip(got["k"].to_pylist(), got["s"].to_pylist())) == \
        dict(zip(uniq.tolist(), counts.tolist()))


def test_count_distinct_folds_on_the_host(events, dsess, strict):
    got = dsess.sql("select status, count(distinct region) as d, "
                    "count(*) as c, sum(qty) as s, avg(qty) as a "
                    "from events where qty > 20 group by status "
                    "order by status")
    f = _filter(events, pc.greater(events["qty"], 20))
    want = f.group_by("status").aggregate([
        ("region", "count_distinct"), ("qty", "count"), ("qty", "sum"),
        ("qty", "mean")]).sort_by("status")
    assert got["d"].to_pylist() == want["region_count_distinct"].to_pylist()
    assert got["c"].to_pylist() == want["qty_count"].to_pylist()
    assert got["s"].to_pylist() == want["qty_sum"].to_pylist()
    assert np.allclose(got["a"].to_numpy(), want["qty_mean"].to_numpy(),
                       rtol=1e-9)


# -- ClickBench's distributed set against the single-device session -------------

@pytest.fixture(scope="module")
def cb_sessions():
    mesh_sess = DistributedSession(_mesh())
    mesh_sess.register_table("hits", pq.read_table(NANO_HITS))
    local, _ = LiquidCacheLocalBuilder(device="cpu").build()
    local.register_parquet("hits", NANO_HITS)
    return mesh_sess, local


@pytest.mark.parametrize("qid", sorted(EXPECT_DISTRIBUTED_CB))
def test_clickbench_distributed(cb_sessions, qid, strict):
    mesh_sess, local = cb_sessions
    sql = (REPO / f"benchmark/clickbench/queries/q{qid}.sql").read_text() \
        .strip().rstrip(";")
    d0 = mesh_sess.route_stats["distributed"]
    got = mesh_sess.sql(sql)
    assert mesh_sess.route_stats["distributed"] == d0 + 1
    want = local.sql(sql).to_arrow()
    key = oracle.DIST_CB[qid]
    cut = oracle.CUTS.get(key)
    if cut is not None and " LIMIT " in sql.upper():
        # the tie rule reads every row of the answer
        want = local.sql(sql[:sql.upper().rindex(" LIMIT ")]).to_arrow()
    assert oracle.same_table(got, want.columns, cut), (got, want)
    # and the pyarrow oracle on the same file
    assert oracle.same_table(got, oracle.answers({"hits": NANO_HITS},
                                                 [key])[key], cut)


# -- the route to the single-device engine ------------------------------------------

def test_unsupported_shape_takes_the_single_device_route(events, monkeypatch):
    monkeypatch.delenv("LIQUID_DIST_STRICT", raising=False)
    s = DistributedSession(_mesh())
    s.register_table("events", events)
    sql = ("select region, qty from events where qty > 97 union all "
           "select region, qty from events where qty < 2")
    got = s.sql(sql)
    assert s.route_stats["fallback"] == 1
    assert s.route_stats["distributed"] == 0
    assert "set operations" in s.route_stats["fallback_reasons"][0]
    q = events["qty"]
    assert got.num_rows == pc.sum(pc.or_(pc.greater(q, 97),
                                         pc.less(q, 2))).as_py()
    monkeypatch.setenv("LIQUID_DIST_STRICT", "1")
    with pytest.raises(dist.MeshUnsupported, match="set operations"):
        s.sql(sql)


def test_other_errors_propagate(events, monkeypatch):
    monkeypatch.delenv("LIQUID_DIST_STRICT", raising=False)
    s = DistributedSession(_mesh())
    s.register_table("events", events)

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(s, "selection", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.sql("select count(*) from events where qty > 3")
    assert s.route_stats == {"distributed": 0, "fallback": 0,
                             "fallback_reasons": []}


def test_string_not_in_subquery_with_null_keeps_no_row(strict):
    s = DistributedSession(_mesh())
    s.register_table("t", pa.table({"s": ["a", "b", "c", None, "d"],
                                    "v": [1, 2, 3, 4, 5]}))
    s.register_table("u", pa.table({"x": ["a", None, "zz"]}))
    s.register_table("w", pa.table({"x": ["a", "zz"]}))
    # SQL: x NOT IN (.., NULL) is never TRUE
    got = s.sql("select count(*) as c from t where s not in "
                "(select x from u)")
    assert got["c"].to_pylist() == [0]
    got = s.sql("select count(*) as c, sum(v) as sv from t where s not in "
                "(select x from w)")
    t = pa.table({"s": ["a", "b", "c", None, "d"], "v": [1, 2, 3, 4, 5]})
    keep = pc.invert(pc.is_in(t["s"], value_set=pa.array(["a", "zz"])))
    keep = pc.and_(keep, pc.is_valid(t["s"]))
    assert got.to_pylist() == [{"c": pc.sum(keep).as_py(), "sv": pc.sum(
        t.filter(keep)["v"]).as_py()}]
    got = s.sql("select count(*) as c from t where s in (select x from u)")
    assert got["c"].to_pylist() == [1]
    assert s.route_stats["fallback"] == 0


def test_columns_off_the_mesh_take_the_single_device_route(monkeypatch):
    """A decimal column stays off the mesh: a query that reads it is
    answered exactly by the single-device engine, the others stay on the
    mesh."""
    import decimal
    monkeypatch.delenv("LIQUID_DIST_STRICT", raising=False)
    s = DistributedSession(_mesh())
    d = [decimal.Decimal(x) for x in ("1.25", "2.50", "0.01", "3.00")]
    s.register_table("t", pa.table({
        "k": [1, 2, 3, 4], "d": pa.array(d, pa.decimal128(15, 2))}))
    assert s.tables["t"].columns["d"].kind == "host"
    assert s.sql("select count(*) as c from t where k > 1").to_pylist() == \
        [{"c": 3}]
    got = s.sql("select sum(d) as s from t where d > 1")
    assert pa.types.is_decimal(got["s"].type)
    assert got["s"].to_pylist() == [decimal.Decimal("6.75")]
    assert s.route_stats["distributed"] == 1
    assert s.route_stats["fallback"] == 1
