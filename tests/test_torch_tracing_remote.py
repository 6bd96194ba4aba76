"""The port's W3C trace propagation on the CPU: a trace that continues
across the client / server boundary (the cases of `tests/test_tracing.py`
that need it) and the cache-trace viewer (`devtools/trace_viz.py`) against the reference's
on the same trace records.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.devtools import trace_viz  # noqa: E402
from liquid_tpu_torch.server import (  # noqa: E402
    AdminServer, LiquidCacheClientBuilder, LiquidCacheService,
)
from liquid_tpu_torch.utils.tracing import TRACER, Tracer  # noqa: E402


@pytest.fixture(autouse=True)
def clean_tracer():
    TRACER.reset()
    TRACER.enable()
    yield
    TRACER.disable()
    TRACER.reset()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_span_nesting_carries_trace_ids():
    with TRACER.span("outer", q=1):
        with TRACER.span("inner"):
            pass
    spans = {s.name: s for s in TRACER.spans()}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["inner"].trace_id == spans["outer"].trace_id
    assert spans["inner"].parent == "outer" and spans["outer"].parent is None
    assert spans["outer"].parent_id is None
    assert len(spans["outer"].trace_id) == 32
    assert len(spans["outer"].span_id) == 16
    assert spans["outer"].attrs["q"] == 1


def test_remote_span_continues_trace():
    with TRACER.span("client"):
        tp = TRACER.current_traceparent()
    with TRACER.remote_span("server", tp):
        with TRACER.span("work"):
            pass
    spans = {s.name: s for s in TRACER.spans()}
    assert tp == f"00-{spans['client'].trace_id}-{spans['client'].span_id}-01"
    assert spans["server"].trace_id == spans["client"].trace_id
    assert spans["server"].parent_id == spans["client"].span_id
    assert spans["work"].parent_id == spans["server"].span_id
    assert spans["work"].trace_id == spans["client"].trace_id


def test_malformed_traceparent_starts_a_fresh_trace():
    with TRACER.span("client") as c:
        pass
    with TRACER.remote_span("server", "not-a-traceparent") as s:
        pass
    assert s.trace_id != c.trace_id and s.parent_id is None
    # a traceparent with no open span names a fresh trace
    assert TRACER.current_traceparent().startswith("00-")


def test_adopt_traceparent_continues_in_this_thread():
    t = Tracer()
    t.enable()
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    t.adopt_traceparent(tp)
    with t.span("server.work") as s:
        pass
    assert (s.trace_id, s.parent_id) == ("ab" * 16, "cd" * 8)
    t.adopt_traceparent("garbage")  # ignored
    with t.span("again") as s2:
        pass
    assert s2.parent_id == "cd" * 8


def test_disabled_tracer_records_nothing():
    t = Tracer()
    with t.span("a") as s, t.remote_span("b", "00-x-y-01") as r:
        pass
    assert s is None and r is None and t.spans() == []


def test_chrome_trace_export_carries_ids(tmp_path):
    with TRACER.span("a"):
        with TRACER.span("b"):
            pass
    out = str(tmp_path / "trace.json")
    assert TRACER.export_chrome_trace(out) == 2
    with open(out) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]}
    assert events["b"]["ph"] == "X" and events["b"]["dur"] >= 0
    assert events["b"]["args"]["parent"] == "a"
    assert events["b"]["args"]["parent_id"] == events["a"]["args"]["span_id"]


def test_end_to_end_propagation_through_server(tmp_path):
    """client.sql span -> traceparent in the ticket -> server.fetch span in
    the same trace; the cache's spans under the server span."""
    t = pa.table({"v": pa.array(np.arange(9000, dtype=np.int64))})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p)
    cache = (LiquidCacheBuilder().with_device("cpu")
             .with_disk_path(str(tmp_path / "s.bin")).build())
    srv = LiquidCacheService(cache)
    host, port = srv.start()
    try:
        client = (LiquidCacheClientBuilder(host, port)
                  .with_parquet_table("t", p).build())
        out = client.sql("SELECT COUNT(*) AS c FROM t WHERE v > 100")
        assert out.column("c")[0].as_py() == 8899
        # partitioned: every stream continues the caller's trace
        scan = (LiquidCacheClientBuilder(host, port)
                .with_parquet_table("t", p).with_partitions(2).build())
        assert scan.sql("SELECT v FROM t WHERE v < 5").num_rows == 5
    finally:
        srv.stop()
    by = _by_name(TRACER.spans())
    csql, scan_sql = by["client.sql"]
    fetches = {s.attrs["handle"]: s for s in by["server.fetch"]}
    agg_fetch = fetches[client._handles[
        "SELECT COUNT(*) AS c FROM t WHERE v > 100"]]
    assert agg_fetch.trace_id == csql.trace_id, "trace did not propagate"
    assert agg_fetch.parent_id == csql.span_id
    # the cache's and the engine's spans ran under the server's span
    assert by["cache.insert"][0].trace_id == csql.trace_id
    execs = [s for s in by["sql.execute"] if s.trace_id == csql.trace_id]
    assert execs and execs[0].parent_id == agg_fetch.span_id
    assert "sql.fused_aggregate" in by or "cache.eval_predicate_many" in by
    parts = [s for s in by["server.fetch"] if s is not agg_fetch]
    assert sorted(s.attrs["partition"] for s in parts) == [0, 1]
    assert {(s.trace_id, s.parent_id) for s in parts} == {
        (scan_sql.trace_id, scan_sql.span_id)}


def _trace_records(tmp_path):
    """A trace parquet written by the admin route from a real query."""
    t = pa.table({"v": pa.array(np.arange(20000, dtype=np.int64) % 977),
                  "s": pa.array([f"k{i % 13}" for i in range(20000)])})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=8192)
    cache = (LiquidCacheBuilder().with_device("cpu")
             .with_disk_path(str(tmp_path / "s.bin")).build())
    srv = LiquidCacheService(cache)
    admin = AdminServer(srv.inner)
    host, port = srv.start()
    ahost, aport = admin.start()
    import urllib.request
    try:
        urllib.request.urlopen(f"http://{ahost}:{aport}/start_trace").read()
        client = (LiquidCacheClientBuilder(host, port)
                  .with_parquet_table("t", p).build())
        client.sql("SELECT s, sum(v) FROM t WHERE v > 3 GROUP BY s")
        out = str(tmp_path / "trace.parquet")
        urllib.request.urlopen(
            f"http://{ahost}:{aport}/stop_trace?path={out}").read()
    finally:
        admin.stop()
        srv.stop()
    return out


def test_trace_viz_agrees_with_the_reference(tmp_path):
    from liquid_tpu.devtools import trace_viz as jviz
    path = _trace_records(tmp_path)
    recs = trace_viz.load_trace(path)
    assert len(recs) > 0 and recs == jviz.load_trace(path)
    assert {r[1] for r in recs} >= {"insert"}
    sim = trace_viz.simulate_state(recs)
    assert sim == jviz.simulate_state(recs)
    assert sum(s["inserts"] for s in sim) == sum(
        1 for r in recs if r[1] == "insert")
    html = trace_viz.render_html(recs, title="t")
    assert html == jviz.render_html(recs, title="t")
    assert f"{len(recs)} events" in html
    assert trace_viz.render_html([]) == jviz.render_html([])
    out = str(tmp_path / "out.html")
    assert trace_viz.main([path, out]) == 0
    with open(out) as f:
        assert f.read() == trace_viz.render_html(recs, title=path)
