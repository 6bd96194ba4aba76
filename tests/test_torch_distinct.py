"""The port's count(DISTINCT) routes against the JAX package's, both on
the CPU, through each package's `LiquidCacheLocalBuilder` over one table
this test writes and the vendored `nano_hits.parquet`.

Each form is forced by the query's shape, or by switching the device
routes off in both packages: sorted pairs (`distinct_fused_device`, outer
keys with a cardinality bound), the chained two-level hash (an expression
key has no bound) and the host fold (`distinct_two_level`: two DISTINCT
columns, or the device routes off).  The data holds NULL DISTINCT values,
NULL keys, avg / sum / min / max riding along, and scans that select
nothing.  Answers compare row for row after each query's total order:
keys, counts, integer sums and strings exactly, f64 to rtol 1e-12."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.sql import fused_agg as jfa  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

N = 40_000


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distinct")
    rng = np.random.default_rng(23)
    k = rng.integers(0, 40, N)
    words = np.array([f"w{i:03d}" for i in range(300)])
    table = pa.table({
        "k": pa.array(k, mask=rng.random(N) < 0.05),
        "k2": pa.array(rng.integers(-3, 3, N).astype(np.int32)),
        "d": pa.array(rng.integers(-200, 700, N), mask=rng.random(N) < 0.1),
        "sd": pa.array(words[rng.integers(0, 300, N)],
                       mask=rng.random(N) < 0.07),
        "v": pa.array(rng.integers(-1000, 1000, N), mask=rng.random(N) < 0.1),
        "name": pa.array(words[rng.integers(0, 300, N)]),
        "f": pa.array(np.round(rng.normal(0.0, 50.0, N), 2)),
    })
    path = str(d / "t.parquet")
    pq.write_table(table, path, row_group_size=1 << 14)
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for ctx in (jctx, tctx):
        ctx.register_parquet("t", path)
        ctx.register_parquet("hits", NANO_HITS)
    return jctx, tctx, table


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


#: (name, sql, the port's route: distinct_sort | distinct_chained |
#: distinct_fold)
QUERIES = [
    ("sort_grouped", "SELECT k, COUNT(DISTINCT d) AS u, SUM(v), MIN(v), "
     "MAX(name), AVG(v), COUNT(*), COUNT(v) FROM t GROUP BY k "
     "ORDER BY k NULLS FIRST", "distinct_sort"),
    ("sort_string_d", "SELECT k2, COUNT(DISTINCT sd) FROM t WHERE v > 0 "
     "GROUP BY k2 ORDER BY k2", "distinct_sort"),
    ("sort_scalar", "SELECT COUNT(DISTINCT d), COUNT(*), MAX(v) FROM t",
     "distinct_sort"),
    ("sort_top_k", "SELECT k, k2, COUNT(DISTINCT d) AS u FROM t "
     "GROUP BY k, k2 ORDER BY u DESC, k, k2 LIMIT 7", "distinct_sort"),
    ("sort_selects_nothing", "SELECT COUNT(DISTINCT d) FROM t "
     "WHERE v > 990 AND v < 991", "distinct_sort"),
    ("chained_expr_key", "SELECT k * 2 AS kk, COUNT(DISTINCT d), SUM(v), "
     "AVG(v), MIN(name) FROM t GROUP BY k * 2 ORDER BY kk", "distinct_chained"),
    ("chained_top_k", "SELECT v + 1 AS w, COUNT(DISTINCT sd) AS u FROM t "
     "GROUP BY v + 1 ORDER BY u DESC, w LIMIT 5", "distinct_chained"),
    ("fold_two_columns", "SELECT k2, COUNT(DISTINCT d), COUNT(DISTINCT sd), "
     "MAX(v), AVG(v), COUNT(*) FROM t GROUP BY k2 ORDER BY k2",
     "distinct_fold"),
    ("fold_scalar_two_columns", "SELECT COUNT(DISTINCT d), "
     "COUNT(DISTINCT k), SUM(v) FROM t WHERE k2 < 0", "distinct_fold"),
    ("fold_empty_scan", "SELECT COUNT(DISTINCT d), COUNT(DISTINCT k), "
     "SUM(v), COUNT(*) FROM t WHERE v > 100000", "distinct_fold"),
    ("fold_empty_grouped", "SELECT k, COUNT(DISTINCT d), MIN(name) FROM t "
     "WHERE v > 100000 GROUP BY k", "distinct_fold"),
    ("cb_q8", 'SELECT "RegionID", COUNT(DISTINCT "UserID") AS u FROM hits '
     'GROUP BY "RegionID" ORDER BY u DESC, "RegionID" LIMIT 10',
     "distinct_sort"),
    ("cb_q22", 'SELECT "SearchPhrase", MIN("URL"), MIN("Title"), COUNT(*) '
     'AS c, COUNT(DISTINCT "UserID") FROM hits WHERE "Title" LIKE '
     '\'%Google%\' AND "URL" NOT LIKE \'%.google.%\' AND "SearchPhrase" <> '
     '\'\' GROUP BY "SearchPhrase" ORDER BY c DESC, "SearchPhrase" LIMIT 10',
     "distinct_sort"),
]

_ROUTES = ("distinct_sort", "distinct_chained", "distinct_fold")


@pytest.mark.parametrize("name,sql,route", QUERIES,
                         ids=[q[0] for q in QUERIES])
def test_query_matches_reference(sessions, name, sql, route):
    jctx, tctx, _ = sessions
    before = {r: tfa.STATS[r] for r in _ROUTES}
    j_sort = jfa.STATS.get("distinct_sort", 0)
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    moved = {r for r in _ROUTES if tfa.STATS[r] != before[r]}
    assert moved == {route}
    # the reference counts only its sort route
    assert (jfa.STATS.get("distinct_sort", 0) > j_sort) \
        == (route == "distinct_sort")
    _assert_same_answer(ours, ref)
    # warm: the cached plan and stage hints answer identically
    _assert_same_answer(tctx.sql(sql).to_arrow(), ours)


@pytest.mark.parametrize("name", ["sort_grouped", "chained_expr_key",
                                  "sort_scalar"])
def test_forced_host_fold_matches_reference(sessions, monkeypatch, name):
    """With the device routes switched off in both packages, the host
    folds (pandas in the reference, pyarrow in the port) agree."""
    jctx, tctx, _ = sessions
    sql = dict((q[0], q[1]) for q in QUERIES)[name]
    monkeypatch.setattr(jfa, "distinct_fused_device", lambda *a, **k: None)
    monkeypatch.setattr(tfa, "distinct_fused_device", lambda *a, **k: None)
    f0 = tfa.STATS["distinct_fold"]
    ref = jctx.sql(sql).to_arrow()
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["distinct_fold"] == f0 + 1
    _assert_same_answer(ours, ref)


def test_avg_of_a_scaled_float_rides_along(sessions):
    """avg of an ALP float column beside count(DISTINCT): its sum rides
    as an exact scaled integer and decodes divided by 10^scale (checked
    against pyarrow)."""
    _, tctx, table = sessions
    ours = tctx.sql("SELECT k2, COUNT(DISTINCT d) AS u, AVG(f) AS a, "
                    "SUM(f) AS s FROM t GROUP BY k2 ORDER BY k2").to_arrow()
    want = table.group_by("k2").aggregate([
        ("d", "count_distinct", pc.CountOptions(mode="only_valid")),
        ("f", "mean"), ("f", "sum")]).sort_by("k2")
    assert ours.column("k2").to_pylist() == want.column("k2").to_pylist()
    assert ours.column("u").to_pylist() == \
        want.column("d_count_distinct").to_pylist()
    for got, exp in (("a", "f_mean"), ("s", "f_sum")):
        np.testing.assert_allclose(ours.column(got).to_numpy(),
                                   want.column(exp).to_numpy(), rtol=1e-12)


def test_first_pairs_flags_one_row_per_distinct_pair():
    """`_first_pairs`: one flag per distinct (key, d) among live rows with
    a non-NULL d -- whatever order the sort leaves equal pairs in."""
    rng = np.random.default_rng(5)
    n = 5000
    k = torch.from_numpy(rng.integers(0, 7, n))
    kn = torch.from_numpy(rng.random(n) < 0.1)
    d = torch.from_numpy(rng.integers(0, 30, n))
    dn = torch.from_numpy(rng.random(n) < 0.1)
    sel = torch.from_numpy(rng.random(n) < 0.7)
    k = torch.where(kn, 0, k)
    d = torch.where(dn, 0, d)
    flag = tfa._first_pairs(sel, [k, d], [kn, dn]).numpy()
    live = sel.numpy() & ~dn.numpy()
    assert not flag[~live].any()
    pairs = set(zip(np.where(kn.numpy(), -1, k.numpy())[live],
                    d.numpy()[live]))
    got = list(zip(np.where(kn.numpy(), -1, k.numpy())[flag],
                   d.numpy()[flag]))
    assert len(got) == len(set(got)) == len(pairs)
    empty = tfa._first_pairs(torch.zeros(0, dtype=torch.bool),
                             [torch.zeros(0, dtype=torch.int64)],
                             [torch.zeros(0, dtype=torch.bool)])
    assert empty.shape == (0,)
    one = tfa._first_pairs(torch.ones(1, dtype=torch.bool),
                           [torch.zeros(1, dtype=torch.int64)],
                           [torch.zeros(1, dtype=torch.bool)])
    assert one.tolist() == [True]


def test_expression_distinct_raises_naming_it(sessions):
    """count(DISTINCT) of an expression has no fused route (the fused
    aggregate names `count_distinct`); it was a raise before the classic
    path, whose pyarrow aggregator now answers as the reference's."""
    jctx, tctx, _ = sessions
    sql = "SELECT k, COUNT(DISTINCT d + 1) AS n FROM t GROUP BY k ORDER BY k"
    c0 = texec.STATS["classic_aggregates"]
    ours = tctx.sql(sql).to_arrow()
    assert "count_distinct" in tfa.STATS["last_bail"]
    assert texec.STATS["classic_aggregates"] == c0 + 1
    ref = jctx.sql(sql).to_arrow()
    assert ours.to_pylist() == ref.to_pylist()
