"""The port's statement layer and subquery rewriting (`liquid_tpu_torch/
sql/exec.py`) against the JAX package's, both on the CPU, through each
package's `LiquidCacheLocalBuilder` over two small tables this test
writes (NULLs in every column the set operations compare).

Views, a CTE that shadows a view (and the view's return afterwards), the
set operations with and without ALL (INTERSECT binding tighter), SELECT
without FROM and derived-table inlining give the reference's answer:
integers and strings exactly, floats to rtol 1e-9, rows as multisets
unless an ORDER BY fixes them.  The literals that the rewrite makes of
uncorrelated subqueries (an IN list with its NULL, a scalar value) are
the reference's; a correlated subquery no existence probe takes raises
NotImplementedError naming it."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.sql.parser import parse_sql as jparse  # noqa: E402
from liquid_tpu.sql.session import LiquidCacheLocalBuilder as JBuilder  # noqa: E402
from liquid_tpu_torch.bench.oracle import same_table  # noqa: E402
from liquid_tpu_torch.sql import ast as tast  # noqa: E402
from liquid_tpu_torch.sql import exec as texec  # noqa: E402
from liquid_tpu_torch.sql import fused_agg as tfa  # noqa: E402
from liquid_tpu_torch.sql.parser import parse_sql as tparse  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402


def _tables():
    rng = np.random.default_rng(11)
    n = 600
    t = pa.table({
        "a": pa.array(rng.integers(0, 12, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "b": pa.array(rng.integers(0, 30, n), pa.int64()),
        "c": pa.array(rng.random(n) * 10),
        "s": pa.array([f"w{i % 9}" for i in range(n)]),
    })
    m = 300
    u = pa.table({
        "ua": pa.array(rng.integers(0, 8, m), pa.int64(),
                       mask=rng.random(m) < 0.05),
        "ub": pa.array(rng.integers(0, 20, m), pa.int64()),
        "uc": pa.array(rng.random(m) * 10),
    })
    return {"t": t, "u": u}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_statements")
    jctx, _ = JBuilder().with_max_memory_bytes(1 << 30).build()
    tctx, _ = (LiquidCacheLocalBuilder(device="cpu")
               .with_max_memory_bytes(1 << 30).build())
    for name, t in _tables().items():
        path = str(d / f"{name}.parquet")
        pq.write_table(t, path, row_group_size=1 << 14)
        for ctx in (jctx, tctx):
            ctx.register_parquet(name, path)
    return jctx, tctx


def _same(ours: pa.Table, ref: pa.Table, ordered: bool = False):
    """Equal answers: the reference's columns; rows in order when the
    query orders them, else as multisets (floats to rtol 1e-9)."""
    assert ours.column_names == ref.column_names
    cut = (tuple(range(ref.num_columns)) if ordered else (), 0,
           ref.num_rows)
    assert same_table(ours, ref.columns, cut), (ours.to_pylist()[:5],
                                                ref.to_pylist()[:5])


def _both(sessions, *stmts):
    """Run the statements in both sessions -> the last answers."""
    jctx, tctx = sessions
    for sql in stmts:
        ref, ours = jctx.sql(sql).to_arrow(), tctx.sql(sql).to_arrow()
    return ours, ref


V1 = ("CREATE VIEW v AS SELECT a AS k, c AS x, s FROM t WHERE b > 5")
V_QUERY = "SELECT k, sum(x) AS sx, count(*) AS n FROM v GROUP BY k ORDER BY k"


def test_view_answers_and_drops(sessions):
    ours, ref = _both(sessions, V1, V_QUERY)
    assert ours.num_rows > 5
    _same(ours, ref, ordered=True)
    _, tctx = sessions
    assert "v" in tctx._exec.views
    _both(sessions, "DROP VIEW v")
    assert "v" not in tctx._exec.views


def test_cte_shadows_a_view_and_restores_it(sessions):
    _, tctx = sessions
    _both(sessions, V1)
    stored = tctx._exec.views["v"]
    base, _ = _both(sessions, V_QUERY)
    shadow = ("WITH v AS (SELECT b AS k, c * 2 AS x, s FROM t WHERE c < 5) "
              + V_QUERY)
    ours, ref = _both(sessions, shadow)
    _same(ours, ref, ordered=True)
    assert ours.num_rows != base.num_rows  # the CTE, not the view
    assert tctx._exec.views["v"] is stored
    after, ref_after = _both(sessions, V_QUERY)
    _same(after, ref_after, ordered=True)
    _same(after, base, ordered=True)
    _both(sessions, "DROP VIEW v")


L = "SELECT a, b % 3 AS r FROM t WHERE b < 12"
R = "SELECT ua, ub % 3 AS r FROM u WHERE ub < 9"
R2 = "SELECT ua, ub % 2 AS r FROM u WHERE uc > 4"

#: (case, sql): every set operation with and without ALL, INTERSECT's
#: precedence, a chain, and ORDER BY / LIMIT over the combined rows
SETOPS = [
    ("union", f"{L} UNION {R}"),
    ("union_all", f"{L} UNION ALL {R}"),
    ("intersect", f"{L} INTERSECT {R}"),
    ("intersect_all", f"{L} INTERSECT ALL {R}"),
    ("except", f"{L} EXCEPT {R}"),
    ("except_all", f"{L} EXCEPT ALL {R}"),
    ("intersect_binds_tighter", f"{L} UNION {R} INTERSECT {R2}"),
    ("except_then_intersect", f"{L} EXCEPT {R} INTERSECT {R2}"),
    ("union_all_chain", f"{L} UNION {R} UNION ALL {R2}"),
    ("ordered_limit", f"{L} UNION ALL {R} ORDER BY 2 DESC, 1 LIMIT 20"),
]


@pytest.mark.parametrize("name,sql", SETOPS, ids=[c[0] for c in SETOPS])
def test_set_operation(sessions, name, sql):
    ours, ref = _both(sessions, sql)
    assert ref.num_rows > 0
    _same(ours, ref, ordered=name == "ordered_limit")


@pytest.mark.parametrize("sql", [
    "SELECT 1 + 2 AS x, 'a' AS s, 2.5 * 4 AS f",
    "SELECT (SELECT max(b) FROM t) AS m, (SELECT count(*) FROM u) + 1 AS n",
], ids=["literals", "scalar_subqueries"])
def test_select_without_from(sessions, sql):
    ours, ref = _both(sessions, sql)
    assert ours.num_rows == 1
    _same(ours, ref)


def test_derived_table_inlines_onto_the_fused_route(sessions):
    sql = ("SELECT g, sum(v) AS sv, count(*) AS n FROM (SELECT a AS g, "
           "c * 2 AS v, b FROM t WHERE b > 3) AS d WHERE b < 25 GROUP BY g "
           "ORDER BY g")
    f0 = tfa.STATS["fused_queries"]
    ours, ref = _both(sessions, sql)
    assert tfa.STATS["fused_queries"] == f0 + 1
    _same(ours, ref, ordered=True)


def test_derived_table_that_does_not_inline_raises(sessions):
    """A derived table that does not inline (an aggregate inside) was a
    raise before the classic path; now the join source executes it and
    the classic aggregator answers as the reference does."""
    sql = "SELECT max(n) FROM (SELECT a, count(*) AS n FROM t GROUP BY a) AS d"
    c0 = texec.STATS["classic_aggregates"]
    ours, ref = _both(sessions, sql)
    assert texec.STATS["classic_aggregates"] == c0 + 1
    _same(ours, ref, ordered=True)


def _rewritten(ctx, parse, sql):
    """The executor's rewrite of the query's WHERE (its one conjunct)."""
    ex = ctx._exec
    q = ex._qualify(parse(sql))
    return ex._rewrite_subqueries(q.where, ex._scope_cols(q))


IN_SQL = "SELECT count(*) FROM t WHERE b IN (SELECT ua FROM u WHERE ub < 4)"


def test_in_subquery_becomes_the_references_list(sessions):
    jctx, tctx = sessions
    ours = _rewritten(tctx, tparse, IN_SQL)
    ref = _rewritten(jctx, jparse, IN_SQL)
    assert isinstance(ours, tast.InList) and not ours.negated
    got = [v.value for v in ours.items]
    want = [v.value for v in ref.items]
    assert None in want  # u.ua holds NULLs: the list keeps them
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert len(set(got)) == len(got)


def test_scalar_subquery_becomes_the_references_value(sessions):
    jctx, tctx = sessions
    sql = "SELECT count(*) FROM t WHERE c > (SELECT avg(uc) FROM u)"
    ours = _rewritten(tctx, tparse, sql)
    ref = _rewritten(jctx, jparse, sql)
    assert isinstance(ours.right, tast.Literal)
    assert ours.right.value == pytest.approx(ref.right.value, rel=1e-12)
    for cond, want in (("uc > 100", False), ("uc < 5", True)):
        exists = f"SELECT count(*) FROM t WHERE EXISTS (SELECT * FROM u " \
                 f"WHERE {cond})"
        assert _rewritten(tctx, tparse, exists).value is want
        assert _rewritten(jctx, jparse, exists).value is want


@pytest.mark.parametrize("sql", [
    IN_SQL,
    "SELECT count(*) FROM t WHERE b NOT IN (SELECT ub FROM u WHERE uc < 4)",
    "SELECT a, count(*) AS n FROM t WHERE c > (SELECT avg(uc) FROM u) "
    "GROUP BY a ORDER BY a",
    "SELECT a, sum(c) AS sc FROM t GROUP BY a HAVING sum(c) > "
    "(SELECT sum(uc) FROM u) / 20 ORDER BY a",
], ids=["in", "not_in", "scalar_in_where", "scalar_in_having"])
def test_uncorrelated_subquery_answers(sessions, sql):
    ours, ref = _both(sessions, sql)
    _same(ours, ref, ordered=True)


def test_not_in_a_list_with_null_raises(sessions):
    """NOT IN over a subquery that returns a NULL is never true.  The
    reference neither probes it nor fuses it; the port's fused route
    answers it in three-valued logic (`x IN (..., NULL)` is `x IN (...)
    OR UNKNOWN`), where it bailed to the classic path before (and raised
    before the classic path), and agrees with the reference."""
    jctx, tctx = sessions
    sql = ("SELECT count(*) FROM t WHERE b NOT IN (SELECT ua FROM u "
           "WHERE ub < 4)")
    c0 = texec.STATS["classic_aggregates"]
    f0 = tfa.STATS["fused_scalar"]
    ours = tctx.sql(sql).to_arrow()
    assert tfa.STATS["fused_scalar"] == f0 + 1
    assert texec.STATS["classic_aggregates"] == c0
    assert ours.column(0).to_pylist() == [0]
    # a reference session of its own: its plan cache keys a subquery by
    # its kind, so after this file's IN query it would reuse that plan
    fresh, _ = JBuilder().with_max_memory_bytes(1 << 28).build()
    for name, table in jctx._tables.items():
        fresh.register_parquet(name, table.path)
    _same(ours, fresh.sql(sql).to_arrow(), ordered=True)


def test_correlated_subquery_no_probe_takes_raises(sessions):
    """A correlated scalar subquery no existence probe takes was a raise
    before the classic path; now it is a lookup (`CorrLookup`) into its
    inner aggregate, evaluated by the classic scan."""
    sql = ("SELECT count(*) FROM t WHERE c > (SELECT avg(uc) FROM u "
           "WHERE ub = b)")
    c0 = texec.STATS["classic_aggregates"]
    ours, ref = _both(sessions, sql)
    assert texec.STATS["classic_aggregates"] == c0 + 1
    _same(ours, ref, ordered=True)
