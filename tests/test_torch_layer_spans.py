"""The program's spans inside the fused and classic routes, on the CPU at
tiny sizes: the star route's plan-cache lookup, planning and dimension
builds on a first run and not on a second, the classic group-by's
`exec.*` and `agg.*` spans, the copies' `wait.*` spans, the naming
rule that keeps `sql.host_self_ms` reading what it read (no new `sql.*`
or `cache.*` span under `sql.execute`), the route and bail-out reason on
`sql.execute`, and a disabled tracer recording nothing while answering
the same."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from liquid_tpu_torch.bench import main as bench  # noqa: E402
from liquid_tpu_torch.bench import tpch_data  # noqa: E402
from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from liquid_tpu_torch.utils.tracing import (  # noqa: E402
    TRACER, to_device, to_host)

SF = 0.005
Q3 = next(q[3] for q in bench.queries(1, 1) if q[0] == "tpch_q3")
#: a ClickBench GROUP BY the fused routes pass on (a string-valued CASE,
#: as ClickBench q39's), so the classic path answers it
CB_CLASSIC = ('SELECT CASE WHEN "SearchEngineID" = 0 THEN "Referer" ELSE '
              '\'\' END AS src, "RegionID", COUNT(*) AS c FROM hits '
              'GROUP BY src, "RegionID" ORDER BY c DESC LIMIT 10')
#: one query per route, with the route and bail-out reason that
#: `sql.execute` names
ROUTES = [
    ("metadata", 'SELECT COUNT(*) FROM hits', None),
    ("fused", 'SELECT "RegionID", COUNT(*) AS c FROM hits GROUP BY '
              '"RegionID" ORDER BY c DESC LIMIT 5', None),
    ("distinct", 'SELECT COUNT(DISTINCT "UserID") FROM hits', None),
    ("select", 'SELECT "URL" FROM hits WHERE "RegionID" = 229 '
               'ORDER BY "EventTime" LIMIT 3', None),
    ("classic", CB_CLASSIC, "literal ''"),
    # the outer query decides the route, not its scalar subquery (fused)
    ("classic", CB_CLASSIC.replace(
        "GROUP BY", 'WHERE "RegionID" > (SELECT MIN("RegionID") FROM hits) '
                    'GROUP BY'), "literal ''"),
    ("star", Q3, None),
]
#: the spans the program had before its layer spans; a new span under
#: `sql.execute` takes one of NEW_PREFIXES
OLD = {"sql.execute", "sql.fused_select", "sql.fused_distinct",
       "sql.fused_aggregate", "sql.fused_star", "sql.windows", "cache.insert",
       "cache.get", "cache.eval_predicate", "cache.eval_predicate_many",
       "cache.get_arrow_many"}
NEW_PREFIXES = ("exec.", "agg.", "fused.", "wait.")


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("layer_spans")
    return tpch_data.write_parquet(tpch_data.generate(SF), str(d))


@pytest.fixture
def ctx(tpch_dir):
    """A fresh session (empty plan and build caches) over TPC-H and
    `nano_hits`."""
    c, _ = (LiquidCacheLocalBuilder(device="cpu")
            .with_max_memory_bytes(1 << 30).build())
    for name, path in tpch_dir.items():
        c.register_parquet(name, path)
    c.register_parquet("hits", NANO_HITS)
    return c


@pytest.fixture
def tracer():
    TRACER.reset()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


def _traced(ctx, sql):
    """(the answer, the spans of one traced run, in start order)."""
    TRACER.reset()
    out = ctx.sql(sql).to_arrow()
    return out, sorted(TRACER.spans(), key=lambda s: s.start)


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _one(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, (name, [s.name for s in spans])
    return got[0]


def test_star_query_plans_builds_issues_fetches_and_finishes(ctx, tracer):
    out, spans = _traced(ctx, Q3)
    assert out.num_rows > 0
    ex = _one(spans, "sql.execute")
    star = _one(_children(spans, ex), "sql.fused_star")
    under = _children(spans, star)
    lookup = _one(under, "fused.lookup")
    plan = _one(_children(spans, lookup), "fused.plan")
    assert [s.name for s in _children(spans, plan)
            if s.name == "fused.dim_build"]
    # after the lookup: the program enqueued, its result fetched, then
    # the result built on the host
    after = [s.name for s in under if s.start >= lookup.end]
    issue, fetch, finish = (after.index("fused.issue"),
                            after.index("wait.fetch"),
                            after.index("fused.finish"))
    assert issue < fetch < finish
    for s in spans:
        if s is not ex:
            assert ex.start <= s.start <= s.end <= ex.end


def test_warm_star_run_looks_up_without_planning(ctx, tracer):
    # the cold run caches the columns, which moves the cache epoch that
    # keys its plan; the first warm run plans again under the settled
    # epoch, and the next one finds that plan
    _, cold = _traced(ctx, Q3)
    _, warm = _traced(ctx, Q3)
    for spans in (cold, warm):
        assert [s for s in spans if s.name == "fused.plan"]
    _, spans = _traced(ctx, Q3)
    lookup = _one(spans, "fused.lookup")
    assert _children(spans, lookup) == []
    assert not [s for s in spans
                if s.name in ("fused.plan", "fused.dim_build")]
    assert [s for s in spans if s.name == "fused.issue"]


def test_classic_group_by_spans(ctx, tracer):
    out, spans = _traced(ctx, CB_CLASSIC)
    assert out.num_rows == 10
    ex = _one(spans, "sql.execute")
    names = {s.name for s in spans}
    assert {"exec.scan", "agg.update", "agg.reduce", "agg.finalize",
            "exec.project", "exec.order_limit", "wait.fetch"} <= names
    byid = {s.span_id: s for s in spans}
    # one scan span per block, each closed before the next block is read:
    # the scan's own reads stay directly under the statement
    for s in spans:
        if s.name == "exec.scan":
            assert s.parent_id == ex.span_id
        if s.name.startswith("cache."):
            assert byid[s.parent_id].name not in ("exec.scan",)
    # the device reduction runs inside the finalize, the ORDER BY inside
    # the projection
    assert byid[_one(spans, "agg.reduce").parent_id].name == "agg.finalize"
    assert byid[_one(spans, "exec.order_limit").parent_id].name \
        == "exec.project"
    assert byid[_one(spans, "agg.finalize").parent_id] is ex


@pytest.mark.parametrize("route,sql", [(r, q) for r, q, _ in ROUTES[:5]]
                         + [("star", Q3)])
def test_no_new_sql_or_cache_span_under_the_statement(ctx, tracer, route,
                                                      sql):
    for _run in range(2):  # first (planning, caching) and warm runs
        _, spans = _traced(ctx, sql)
        byid = {s.span_id: s for s in spans}
        ex = _one(spans, "sql.execute")
        for s in spans:
            assert s.name in OLD or s.name.startswith(NEW_PREFIXES), s.name
            if s.parent_id == ex.span_id and s.name.startswith(
                    ("sql.", "cache.")):
                assert s.name in OLD, s.name
            if not s.name.startswith("cache."):
                continue
            # a cache span outside every sql.* child keeps sql.execute as
            # its parent, so sql.host_self_ms subtracts it as before
            path, p = [], byid[s.parent_id]
            while p is not ex:
                path.append(p.name)
                p = byid[p.parent_id]
            if not any(n.startswith("sql.") for n in path):
                assert all(n.startswith("cache.") for n in path), \
                    (s.name, path)


@pytest.mark.parametrize("route,sql,bail", ROUTES)
def test_statement_names_its_route_and_bail(ctx, tracer, route, sql, bail,
                                            tmp_path):
    _, spans = _traced(ctx, sql)
    ex = _one(spans, "sql.execute")
    assert ex.attrs["route"] == route
    assert ex.attrs["bail"] == bail
    path = str(tmp_path / "trace.json")
    TRACER.export_chrome_trace(path)
    with open(path) as f:
        (ev,) = [e for e in json.load(f)["traceEvents"]
                 if e["name"] == "sql.execute"]
    assert (ev["args"]["route"], ev["args"]["bail"]) == (route, bail)


@pytest.mark.parametrize("sql", [Q3, CB_CLASSIC, ROUTES[2][1]])
def test_disabled_tracer_records_nothing_and_answers_the_same(ctx, sql):
    TRACER.disable()
    TRACER.reset()
    cold = ctx.sql(sql).to_arrow()
    untraced = ctx.sql(sql).to_arrow()
    assert TRACER.spans() == []
    TRACER.enable()
    try:
        traced = ctx.sql(sql).to_arrow()
        assert TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.reset()
    assert traced.equals(untraced) and cold.equals(untraced)


@pytest.mark.parametrize("copy,name", [
    (to_host, "wait.fetch"), (lambda t: to_device(t, "cpu"), "wait.upload")])
def test_copies_are_wait_spans_only_while_tracing(tracer, copy, name):
    t = torch.arange(5)
    assert torch.equal(copy(t), t)
    (s,) = TRACER.spans()
    assert s.name == name and s.end >= s.start
    TRACER.disable()
    TRACER.reset()
    assert torch.equal(copy(t), t) and TRACER.spans() == []


def test_disabled_span_is_one_shared_no_op_and_ids_are_w3c(tracer):
    with TRACER.span("a") as a:
        with TRACER.span("b") as b:
            pass
    assert a.span_id != b.span_id and b.parent_id == a.span_id
    for s in (a, b):
        assert len(s.span_id) == 16 and int(s.span_id, 16) >= 0
        assert len(s.trace_id) == 32
    TRACER.disable()
    assert TRACER.span("x") is TRACER.span("y", k=1)
    with TRACER.span("x") as none:
        assert none is None
    assert [s.name for s in TRACER.spans()] == ["b", "a"]
