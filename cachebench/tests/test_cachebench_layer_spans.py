"""The readers of the program's layer spans (`fused.*`, `agg.*`,
`wait.*`), on made-up records, and on the card the containment of the
profiler's blocking runtime calls in the program's `wait.*` spans."""
import pytest

from cachebench import harness, spans, spec, trace
from cachebench.trace import SpanRec

NEW = ("fused.plan_miss_pct", "fused.plan_ms", "fused.issue_ms",
       "agg.host_ms", "sql.card_wait_ms")


def _run(spans_, completed=2):
    return harness.Run("tpch_sf1.fused", window_start=0, window_end=10_000,
                       completed=completed, spans=spans_)


#: a star query that plans (its dimension build and uniqueness fetch
#: inside the plan), issues and fetches; then a run that hits the cache;
#: then a classic group-by whose reduce nests in an update
STAR = [
    SpanRec("sql.execute", 0, 1000, "e1", ""),
    SpanRec("sql.fused_star", 10, 900, "s1", "e1"),
    SpanRec("fused.lookup", 20, 500, "l1", "s1"),
    SpanRec("fused.plan", 30, 480, "p1", "l1"),
    SpanRec("fused.dim_build", 40, 200, "d1", "p1"),
    SpanRec("wait.fetch", 150, 190, "w1", "d1"),
    SpanRec("wait.fetch", 300, 350, "w2", "p1"),
    SpanRec("fused.issue", 500, 600, "i1", "s1"),
    SpanRec("wait.fetch", 600, 700, "w3", "s1"),
    SpanRec("fused.finish", 700, 800, "f1", "s1"),
    SpanRec("sql.execute", 2000, 2500, "e2", ""),
    SpanRec("sql.fused_star", 2010, 2400, "s2", "e2"),
    SpanRec("fused.lookup", 2020, 2050, "l2", "s2"),
    SpanRec("fused.issue", 2050, 2090, "i2", "s2"),
    SpanRec("wait.fetch", 2090, 2300, "w4", "s2"),
]
CLASSIC = [
    SpanRec("sql.execute", 3000, 5000, "e3", ""),
    SpanRec("exec.scan", 3100, 3500, "c1", "e3"),
    SpanRec("agg.update", 3200, 3450, "u1", "c1"),
    SpanRec("agg.reduce", 3300, 3400, "r1", "u1"),
    SpanRec("wait.fetch", 3350, 3390, "w5", "r1"),
    SpanRec("agg.finalize", 3600, 4000, "z1", "e3"),
    SpanRec("agg.reduce", 3600, 3800, "r2", "z1"),
    SpanRec("wait.fetch", 3700, 3760, "w6", "r2"),
    SpanRec("exec.project", 4000, 4500, "j1", "e3"),
    SpanRec("exec.order_limit", 4100, 4400, "o1", "j1"),
]


@pytest.mark.parametrize("name,want", [
    # one of two lookups planned
    ("fused.plan_miss_pct", 50.0),
    # the plan's 450 ns less the 40 + 50 ns of fetches it holds
    ("fused.plan_ms", (450 - 90) / 1e6 / 2),
    ("fused.issue_ms", (100 + 40) / 1e6 / 2),
    # no agg.* span in these queries
    ("agg.host_ms", 0.0),
    ("sql.card_wait_ms", (40 + 50 + 100 + 210) / 1e6 / 2),
])
def test_fused_readers(name, want):
    assert spec.metric(name).read(_run(STAR)) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("fused.plan_miss_pct", 0.0),
    ("fused.plan_ms", 0.0),
    ("fused.issue_ms", 0.0),
    # the outermost agg.* spans: the update (250, holding the reduce and
    # its 40 ns fetch) and the finalize (400, holding a 60 ns fetch)
    ("agg.host_ms", (250 - 40 + 400 - 60) / 1e6),
    ("sql.card_wait_ms", (40 + 60) / 1e6),
])
def test_classic_readers(name, want):
    got = spec.metric(name).read(_run(CLASSIC, completed=1))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_readers_need_the_programs_layer_spans(name):
    reader = spec.metric(name)
    # an older program records sql.execute and no layer span: no reading
    assert reader.read(_run([SpanRec("sql.execute", 0, 10, "e", ""),
                             SpanRec("sql.fused_star", 1, 9, "s", "e")])) \
        is None
    # no queries, or no sql.execute span, read nothing either
    assert reader.read(_run(STAR, completed=0)) is None
    assert reader.read(_run([SpanRec("wait.fetch", 0, 10, "w", "")])) is None
    # a layer span of any kind makes every reader read
    assert reader.read(_run([SpanRec("sql.execute", 0, 10, "e", ""),
                             SpanRec("exec.project", 1, 9, "j", "e")])) \
        == 0.0


def test_new_metrics_are_program_span_readers_of_qps():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["source"], m["moves"]) == ("program_span", "qps")
        assert "workloads" not in m
        assert callable(spec.metric(name).read)


def test_wait_offsets_and_coverage():
    sp = [SpanRec("sql.execute", 0, 1000, "e", ""),
          SpanRec("wait.fetch", 100, 200, "w1", "e"),
          SpanRec("wait.fetch", 300, 400, "w2", "e"),
          SpanRec("wait.fetch", 500, 600, "w3", "e")]
    # a memcpy and a synchronize inside w1, a call that sticks out of w2
    # by 5 at its end, none in w3; one call outside every wait span and
    # one outside sql.execute
    calls = [(110, 150), (150, 190), (320, 405), (700, 800), (1100, 1200)]
    assert spans.wait_offsets(sp, calls) == [(100, 10, 10), (300, 20, -5)]
    total, covered = spans.wait_coverage(sp, calls)
    assert (total, covered) == (40 + 40 + 85 + 100, 40 + 40 + 80)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_wait_spans_hold_the_profilers_blocking_calls(card):
    """Each `to_host` fetch's blocking runtime calls, on the profiler's
    clock shifted as `DeviceTrace` shifts it, lie inside its `wait.fetch`
    span within 50 us at both ends."""
    import torch
    from liquid_tpu_torch.utils.tracing import TRACER, to_host
    x = torch.arange(1 << 24, device="cuda")
    TRACER.reset()
    TRACER.enable()
    try:
        with trace.DeviceTrace(torch) as dev:
            for i in range(64):
                int(to_host((x * i).sum()))
                to_host(x[: 1 << (i % 24)])
    finally:
        TRACER.disable()
    recs = trace.spans_of(TRACER)
    TRACER.reset()
    offsets = spans.wait_offsets(recs, dev.waits)
    assert len(offsets) == 128
    assert min(min(a, b) for _t, a, b in offsets) >= -50_000, offsets
