"""The port's disaggregated server on the CPU: the cases of
`tests/test_server.py` (a Flight client and server over localhost, the
mock object store, the byte cache, the admin routes), against pyarrow,
plus one aggregate and one partitioned scan answered equal to the JAX
package's service on the same file, and one client answering across its
own and another client's resets (a stale plan handle is a named error
that the client answers by registering its query again, once).

The server starts once per module on a `device="cpu"` cache; each test
uses queries of its own, so the tests do not depend on their order.
"""
import io
import json
import threading
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.compute as pc  # noqa: E402
import pyarrow.flight as fl  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.cache.core import LiquidCacheBuilder  # noqa: E402
from liquid_tpu_torch.common import rpc  # noqa: E402
from liquid_tpu_torch.common.object_store import (  # noqa: E402
    ByteCache, MockStore, StoreFile, sanitize_url,
)
from liquid_tpu_torch.server import (  # noqa: E402
    AdminServer, LiquidCacheClientBuilder, LiquidCacheService,
)
from liquid_tpu_torch.server import admin as tadmin  # noqa: E402
from liquid_tpu_torch.server.client import StalePlanHandle  # noqa: E402

TABLE = "mock://b!hits.parquet"


def _make_parquet_bytes(n=20_000, seed=3, row_group_size=None):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "val": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        "name": pa.array(rng.choice(["alpha", "beta", "gamma"], n)),
    })
    sink = io.BytesIO()
    pq.write_table(t, sink, row_group_size=row_group_size)
    return t, sink.getvalue()


def _store_put(inner, url, path, data):
    store = inner.stores[url]
    upstream = store.inner if isinstance(store, ByteCache) else store
    upstream.put(path, data)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    t, data = _make_parquet_bytes()
    cache = (LiquidCacheBuilder().with_device("cpu")
             .with_max_memory_bytes(1 << 26)
             .with_disk_path(str(tmp / "store.bin")).build())
    srv = LiquidCacheService(cache, byte_cache_dir=str(tmp / "bc"))
    srv.inner.register_object_store("mock://b", {})
    _store_put(srv.inner, "mock://b", "hits.parquet", data)
    admin = AdminServer(srv.inner)
    host, port = srv.start()
    aaddr = admin.start()
    try:
        yield srv, (host, port), t, data, tmp, aaddr
    finally:
        admin.stop()
        srv.stop()
    assert not srv._thread.is_alive() and not admin._thread.is_alive()


def _client(addr, partitions=1):
    return (LiquidCacheClientBuilder(*addr)
            .with_parquet_table("hits", TABLE)
            .with_partitions(partitions).build())


def _plans_of(srv, sql):
    return [e for e in srv.inner.plans.values() if e["sql"] == sql]


def test_cache_runs_on_the_asked_device(served):
    srv, *_ = served
    assert srv.inner.cache.device.type == "cpu"
    assert srv.inner.ctx.device.type == "cpu"


def test_end_to_end_query(served):
    srv, addr, t, *_ = served
    client = _client(addr)
    out = client.sql("SELECT name, COUNT(*) AS c, SUM(val) AS s FROM hits "
                     "WHERE val > 500 GROUP BY name ORDER BY name")
    ref = (t.filter(pc.greater(t["val"], 500))
           .group_by("name").aggregate([("val", "count"), ("val", "sum")])
           .sort_by("name"))
    assert out.column("name").to_pylist() == ref["name"].to_pylist()
    assert out.column("c").to_pylist() == ref["val_count"].to_pylist()
    assert out.column("s").to_pylist() == ref["val_sum"].to_pylist()
    m = client.last_metrics
    assert m.rows == ref.num_rows and m.batches >= 1
    assert m.time_to_first_batch_ms > 0
    assert m.total_stream_ms >= m.time_to_first_batch_ms


def test_plan_registered_once_across_threads(served):
    srv, addr, t, *_ = served
    client = _client(addr)
    sql = "SELECT COUNT(*) AS c FROM hits WHERE id >= 0"
    outs = [None] * 8

    def run(i):
        outs[i] = client.sql(sql)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for o in outs:
        assert o.column("c")[0].as_py() == t.num_rows
    # the latch admitted exactly one registration
    assert len(_plans_of(srv, sql)) == 1


def test_partitioned_streams(served):
    srv, addr, t, *_ = served
    client = _client(addr, partitions=4)
    sql = "SELECT id FROM hits WHERE val <= 100 ORDER BY id"
    out = client.sql(sql)
    ref = sorted(t.filter(pc.less_equal(t["val"], 100))["id"].to_pylist())
    assert sorted(out.column("id").to_pylist()) == ref
    # ORDER BY makes it an executed-once plan, sliced across 4 streams
    assert _plans_of(srv, sql)[0]["scan_table"] is None
    assert client.last_metrics.rows == len(ref)


def test_execution_metrics_and_stats(served):
    srv, addr, *_ = served
    client = _client(addr)
    sql = "SELECT SUM(val) AS s FROM hits"
    client.sql(sql)
    m = client.execution_metrics(sql)
    assert m.cache_memory_usage > 0
    st = client.server_stats()
    assert st["inserts"] > 0
    client.reset_cache()
    st2 = client.server_stats()
    assert st2["entries"] == 0
    assert srv.inner.plans == {}


def test_server_side_error_propagates(served):
    _srv, addr, *_ = served
    client = LiquidCacheClientBuilder(*addr).build()
    with pytest.raises(RuntimeError):
        client.sql("SELECT * FROM does_not_exist")
    with pytest.raises(RuntimeError):
        client._call("no_such_action", {})


def test_failed_partition_fails_the_query(served, monkeypatch):
    """One partition's failure raises; its rows are never left out."""
    srv, addr, *_ = served
    real = srv.inner.execute_partition_stream

    def broken(handle, partition):
        if partition == 2:
            raise ValueError("partition 2 is broken")
        return real(handle, partition)
    monkeypatch.setattr(srv.inner, "execute_partition_stream", broken)
    client = _client(addr, partitions=4)
    with pytest.raises(RuntimeError, match="partition 2 is broken"):
        client.sql("SELECT id FROM hits WHERE val = 7")


# -- mock store + byte cache ---------------------------------------------------

def test_mock_store_instrumentation():
    ms = MockStore({"a": b"0123456789"})
    assert ms.get_range("a", 2, 3) == b"234"
    assert ms.get("a") == b"0123456789"
    assert ms.get_access_count("a") == 2
    assert ms.get_access_ranges("a") == [(2, 5), (0, 10)]
    fork = ms.fork()
    assert fork.get_access_count("a") == 0
    assert fork.get("a") == b"0123456789"
    assert ms.get_access_count("a") == 2  # the fork is isolated


def test_byte_cache_block_alignment(tmp_path):
    """Reads through the cache hit the upstream in aligned blocks, once
    per block."""
    blob = bytes(range(256)) * 40  # 10240 bytes
    ms = MockStore({"obj": blob})
    bc = ByteCache(ms, str(tmp_path / "bc"), block_size=4096)
    assert bc.get_range("obj", 100, 50) == blob[100:150]
    assert ms.get_access_ranges("obj") == [(0, 4096)]
    assert bc.get_range("obj", 200, 100) == blob[200:300]
    assert ms.get_access_count("obj") == 1
    assert bc.get_range("obj", 4000, 5000) == blob[4000:9000]
    assert ms.get_access_count("obj") == 3
    assert bc.cached_blocks("obj") == 3
    assert bc.disk_usage() == 4096 + 4096 + (10240 - 8192)
    assert bc.get("obj") == blob


def test_store_file_parquet_roundtrip(tmp_path):
    t, data = _make_parquet_bytes(5000)
    ms = MockStore({"f.parquet": data})
    bc = ByteCache(ms, str(tmp_path / "bc"))
    got = pq.read_table(StoreFile(bc, "f.parquet"))
    assert got.equals(t)


def test_prefetch_warms_byte_cache(served):
    srv, addr, t, data, *_ = served
    client = _client(addr)
    n = client.prefetch("mock://b", "hits.parquet")
    assert n == len(data)
    upstream = srv.inner.stores["mock://b"].inner
    before = upstream.get_access_count("hits.parquet")
    out = client.sql("SELECT COUNT(*) AS c FROM hits WHERE val < 999")
    assert out.column("c")[0].as_py() == pc.sum(
        pc.less(t["val"], 999)).as_py()
    # served from the byte cache: no new upstream read
    assert upstream.get_access_count("hits.parquet") == before


def test_sanitize_url():
    assert sanitize_url("s3://bucket/a b!") == "s3___bucket_a_b_"


# -- admin server ---------------------------------------------------------------

def _http(addr, path):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}") as r:
        body = r.read()
    try:
        return json.loads(body)
    except ValueError:
        return body.decode()


def test_admin_endpoints(served):
    srv, addr, t, data, tmp, aaddr = served
    client = _client(addr)
    sql = "SELECT COUNT(*) AS c FROM hits WHERE val < 10"
    # from an empty cache, so the query's reads insert and are traced
    _http(aaddr, "/reset_cache")
    _http(aaddr, "/start_trace")
    out = client.sql(sql)
    assert out.column("c")[0].as_py() == pc.sum(pc.less(t["val"], 10)).as_py()
    stats = _http(aaddr, "/cache_stats")
    assert stats["inserts"] > 0
    info = _http(aaddr, "/cache_info")
    assert info["memory_usage_bytes"] > 0 and info["entries"] > 0
    assert info["batch_size"] == srv.inner.cache.batch_size
    sysinfo = _http(aaddr, "/system_info")
    assert sysinfo["pid"] > 0
    trace = _http(aaddr, "/stop_trace")
    assert len(trace["trace"]) > 0
    assert set(trace["trace"][0]) == {"ts", "op", "entry_id", "nbytes"}
    plans = _http(aaddr, "/execution_plans")
    mine = [p for p in plans.values() if p["sql"] == sql]
    assert len(mine) == 1 and mine[0]["executed"]
    handle = next(h for h, p in plans.items() if p["sql"] == sql)
    metrics = _http(aaddr, f"/execution_metrics?handle={handle}")
    assert set(metrics) == set(rpc.ExecutionMetricsResponse().__dict__)
    assert metrics["cache_memory_usage"] > 0
    usage = _http(aaddr, "/parquet_cache_usage")
    assert usage["memory_used"] > 0
    req = urllib.request.Request(
        f"http://{aaddr[0]}:{aaddr[1]}/add_execution_stats",
        data=json.dumps({"query": sql, "ms": 1.5}).encode(), method="POST")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read()) == {"ok": True}
    assert srv.inner.execution_stats[-1] == {"query": sql, "ms": 1.5}
    _http(aaddr, "/start_disk_usage_monitor?path=" + str(tmp))
    mon = _http(aaddr, "/stop_disk_usage_monitor")
    assert len(mon["samples"]) >= 1 and mon["samples"][0][1] > 0
    _http(aaddr, "/reset_cache")
    assert _http(aaddr, "/cache_stats")["entries"] == 0
    # a query after the reset reads the file again and still answers
    out = client.sql(sql + " AND id >= 0")
    assert out.column("c")[0].as_py() == pc.sum(pc.less(t["val"], 10)).as_py()
    with pytest.raises(urllib.error.HTTPError):
        _http(aaddr, "/nope")


@pytest.mark.parametrize("partitions", [1, 3])
def test_a_client_answers_across_resets(served, partitions):
    """One client answers the same query before and after its own
    `reset_cache` and after another client's reset: its reset forgets
    its handles, and a fetch that meets the server's named error for a
    stale handle registers the query again, once."""
    srv, addr, t, *rest = served
    aaddr = rest[-1]
    client = _client(addr, partitions)
    # a partitionable scan (per row group) and an executed-once plan
    scan = f"SELECT id, val FROM hits WHERE val = {partitions + 40}"
    agg = ("SELECT name, COUNT(*) AS c FROM hits WHERE val >= "
           f"{900 + partitions} GROUP BY name ORDER BY name")
    want = {scan: sorted(t.filter(pc.equal(t["val"], partitions + 40))
                         ["id"].to_pylist()),
            agg: t.filter(pc.greater_equal(t["val"], 900 + partitions))
            .group_by("name").aggregate([("val", "count")])
            .sort_by("name")["val_count"].to_pylist()}

    def answer(sql):
        out = client.sql(sql)
        return sorted(out["id"].to_pylist()) if sql == scan \
            else out["c"].to_pylist()

    for sql in want:
        assert answer(sql) == want[sql]
    assert client.registrations == 2
    stale = dict(client._handles)
    client.reset_cache()
    assert client._handles == {} and srv.inner.plans == {}
    for sql in want:
        assert answer(sql) == want[sql]
    assert client.registrations == 4
    # another client's reset leaves this one's handles stale
    _client(addr).reset_cache()
    for sql in want:
        assert answer(sql) == want[sql]
    assert client.registrations == 6
    with pytest.raises(urllib.error.HTTPError) as ex:
        _http(aaddr, f"/execution_metrics?handle={stale[agg]}")
    assert ex.value.code == 404
    # the service names the handle it does not hold
    for call in (lambda h: srv.inner.execute_partition(h, 0),
                 lambda h: next(srv.inner.execute_partition_stream(h, 0)),
                 srv.inner.metrics):
        with pytest.raises(fl.FlightServerError,
                           match=f"{rpc.UNKNOWN_HANDLE} '{stale[scan]}'"):
            call(stale[scan])


def test_a_second_stale_handle_is_raised(served, monkeypatch):
    """A fetch re-registers its query once; if the server still holds no
    plan under the new handle, the client raises."""
    srv, addr, *_ = served
    client = _client(addr)
    sql = "SELECT COUNT(*) AS c FROM hits WHERE val = 7"
    client.sql(sql)
    client._handles[sql] = "gone"  # a handle the server never held
    monkeypatch.setattr(srv.inner, "register_plan", lambda *a, **k: None)
    with pytest.raises(StalePlanHandle, match=rpc.UNKNOWN_HANDLE):
        client.sql(sql)
    assert client.registrations == 2


def test_execution_plans_mark_a_run_scan_executed(served):
    """A partitionable scan keeps no result, yet it ran: the admin route
    says so (the reference's says it never executed)."""
    srv, addr, t, *rest = served
    aaddr = rest[-1]
    sql = "SELECT id FROM hits WHERE val = 13"
    client = _client(addr, partitions=2)
    out = client.sql(sql)
    assert out.num_rows == pc.sum(pc.equal(t["val"], 13)).as_py()
    (ent,) = _plans_of(srv, sql)
    assert ent["scan_table"] == "hits" and ent["result"] is None
    assert ent["runs"] == 2  # one per partition stream
    plans = _http(aaddr, "/execution_plans")
    assert [p["executed"] for p in plans.values() if p["sql"] == sql] == \
        [True]


def test_admin_shutdown_route_stops_both_servers(tmp_path):
    cache = (LiquidCacheBuilder().with_device("cpu")
             .with_disk_path(str(tmp_path / "s.bin")).build())
    srv = LiquidCacheService(cache)
    srv.start()
    done = threading.Event()

    def on_shutdown():
        srv.stop()
        done.set()
    admin = AdminServer(srv.inner, on_shutdown=on_shutdown)
    aaddr = admin.start()
    try:
        assert _http(aaddr, "/shutdown") == {"ok": True}
        assert done.wait(30)
        assert not srv._thread.is_alive()
    finally:
        admin.stop()
    assert not admin._thread.is_alive()


def test_stop_raises_past_its_time_limit():
    """A server that does not stop in time makes `stop` raise."""
    gate = threading.Event()

    class Stuck:
        def shutdown(self):
            gate.wait(10)
    srv = LiquidCacheService.__new__(LiquidCacheService)
    srv._srv, srv._thread = Stuck(), None
    with pytest.raises(RuntimeError, match="did not stop within"):
        srv.stop(timeout=0.2)
    gate.set()


def test_admin_flamegraph(served):
    *_, aaddr = served
    _http(aaddr, "/start_flamegraph")
    seen = threading.Event()

    def busy():
        x = 0
        for i in range(3_000_000):
            x += i
        seen.set()
    th = threading.Thread(target=busy, name="busy")
    th.start()
    th.join()
    folded = _http(aaddr, "/stop_flamegraph")
    assert isinstance(folded, str) and seen.is_set()
    for line in folded.splitlines():
        stack, count = line.rsplit(" ", 1)
        assert int(count) > 0 and stack


def test_flamegraph_samples_other_threads():
    fg = tadmin.Flamegraph(hz=500)
    stop = threading.Event()

    def spin_here():
        while not stop.is_set():
            sum(range(1000))
    th = threading.Thread(target=spin_here)
    th.start()
    fg.start()
    try:
        threading.Event().wait(0.2)
    finally:
        folded = fg.stop()
        stop.set()
        th.join()
    assert "spin_here" in folded


def test_trace_flush_parquet(served, tmp_path):
    _srv, addr, t, *rest = served
    aaddr = rest[-1]
    client = _client(addr)
    _http(aaddr, "/reset_cache")
    _http(aaddr, "/start_trace")
    # needs a filter: a bare COUNT(*) is answered from the metadata alone
    client.sql("SELECT COUNT(*) AS c FROM hits WHERE val > 3")
    out = str(tmp_path / "trace.parquet")
    res = _http(aaddr, f"/stop_trace?path={out}")
    assert res["flushed"] > 0
    tr = pq.read_table(out)
    assert set(tr.column_names) == {"ts", "op", "entry_id", "nbytes"}
    assert tr.num_rows == res["flushed"]


# -- against the JAX package's service -------------------------------------------

@pytest.fixture(scope="module")
def ref_served(tmp_path_factory):
    from liquid_tpu.cache import LiquidCacheBuilder as JCacheBuilder
    from liquid_tpu.server import LiquidCacheService as JService
    tmp = tmp_path_factory.mktemp("ref_server")
    t, _ = _make_parquet_bytes()
    path = str(tmp / "hits.parquet")
    pq.write_table(t, path, row_group_size=8192)
    jsrv = JService(JCacheBuilder().with_disk_path(
        str(tmp / "j.bin")).build())
    tsrv = LiquidCacheService(LiquidCacheBuilder().with_device("cpu")
                              .with_disk_path(str(tmp / "t.bin")).build())
    jaddr, taddr = jsrv.start(), tsrv.start()
    try:
        yield jaddr, taddr, path, t
    finally:
        jsrv.stop()
        tsrv.stop()


def _both(ref_served, sql, partitions):
    from liquid_tpu.server import LiquidCacheClientBuilder as JClientBuilder
    jaddr, taddr, path, _t = ref_served
    outs = []
    for make, addr in ((JClientBuilder, jaddr),
                       (LiquidCacheClientBuilder, taddr)):
        c = (make(*addr).with_parquet_table("hits", path)
             .with_partitions(partitions).build())
        outs.append((c.sql(sql), c))
    return outs


def test_aggregate_equals_the_reference(ref_served):
    sql = ("SELECT name, COUNT(*) AS c, SUM(val) AS s FROM hits "
           "WHERE val > 250 GROUP BY name ORDER BY name")
    (jout, jc), (tout, tc) = _both(ref_served, sql, 1)
    assert tout.to_pylist() == jout.to_pylist()
    assert tout.num_rows == 3
    # the metrics message has the reference's fields
    jm, tm = jc.execution_metrics(sql), tc.execution_metrics(sql)
    assert set(tm.__dict__) == set(jm.__dict__)
    assert type(tm).__name__ == type(jm).__name__


def test_partitioned_scan_equals_the_reference(ref_served):
    sql = "SELECT id, name FROM hits WHERE val < 300"
    (jout, _), (tout, tc) = _both(ref_served, sql, 3)
    key = [("id", "ascending")]
    assert tout.sort_by(key).to_pylist() == jout.sort_by(key).to_pylist()
    t = ref_served[3]
    assert tout.num_rows == pc.sum(pc.less(t["val"], 300)).as_py()
    assert tc.last_metrics.batches >= 3


# -- the wire frames -----------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_rpc_frames_round_trip_with_the_reference(writer):
    """JSON, error and Arrow IPC frames written by one package read back
    by the other, byte for byte the same frames."""
    import socket
    from liquid_tpu.common import rpc as jrpc
    w, r = (jrpc, rpc) if writer == "ref" else (rpc, jrpc)
    t, _ = _make_parquet_bytes(20_000)
    a, b = socket.socketpair()
    try:
        done = threading.Event()

        def send():
            w.write_json(a, w.FetchResults("h", 3, "00-ab-cd-01"))
            w.write_table_stream(a, t, batch_rows=8192)
            w.write_msg(a, w.KIND_ERROR, b"boom")
            done.set()
        th = threading.Thread(target=send)
        th.start()
        assert r.read_json(b) == {"handle": "h", "partition": 3,
                                  "traceparent": "00-ab-cd-01"}
        got = pa.Table.from_batches(list(r.read_table_stream(b)))
        assert got.equals(t)
        with pytest.raises(RuntimeError, match="boom"):
            r.read_json(b)
        th.join()
        assert done.is_set()
    finally:
        a.close()
        b.close()


def test_rpc_messages_have_the_references_fields():
    import dataclasses
    from liquid_tpu.common import rpc as jrpc
    for name in ("RegisterObjectStoreRequest", "RegisterPlanRequest",
                 "PrefetchRequest", "FetchResults",
                 "ExecutionMetricsResponse"):
        assert [(f.name, f.default) for f in dataclasses.fields(
            getattr(rpc, name))] == [(f.name, f.default) for f in
                                     dataclasses.fields(getattr(jrpc, name))]
