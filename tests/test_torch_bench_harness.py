"""The port's benchmark harness on the CPU: the cases of
`tests/test_bench_harness.py` (manifests, the in-process runner's three
modes, stored answers, the server-mode client and the CLI), with the
answers held to pyarrow (`bench/oracle.py`) and the manifests to the JAX
package's loader.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu_torch.bench import main as bench_main  # noqa: E402
from liquid_tpu_torch.bench import oracle, tpch_data, tpch_queries  # noqa: E402
from liquid_tpu_torch.bench.manifest import Manifest  # noqa: E402
from liquid_tpu_torch.bench.runner import (  # noqa: E402
    InProcessRunner, save_answers,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT = "select count(*) as c from lineitem"
#: the bench's q6 text, whose discount bounds are the oracle's literals
#: (the spec text's `0.06 + 0.01` is 0.06999999999999999 in float)
Q6 = dict((q[0], q[3]) for q in bench_main.queries(0, 0))["tpch_q6"]


@pytest.fixture(scope="module")
def tiny_manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    os.makedirs(d / "data")
    path = str(d / "data" / "lineitem.parquet")
    pq.write_table(tpch_data.generate(0.002)["lineitem"], path,
                   row_group_size=1 << 16)
    m = {"name": "tpch-tiny", "tables": {"lineitem": "data/lineitem.parquet"},
         "queries": [tpch_queries.QUERIES[1], Q6, COUNT]}
    mp = d / "manifest.json"
    mp.write_text(json.dumps(m))
    return str(mp), d, {"lineitem": path}


@pytest.fixture(scope="module")
def answers_dir(tiny_manifest, tmp_path_factory):
    mp, _d, _paths = tiny_manifest
    out = str(tmp_path_factory.mktemp("answers"))
    save_answers(Manifest.load(mp), out, device="cpu",
                 cache_dir=str(tmp_path_factory.mktemp("gen")))
    return out


def test_manifest_load_resolves_sql_files(tmp_path):
    (tmp_path / "q0.sql").write_text("select 1 as x;")
    m = {"name": "t", "tables": {"a": "a.parquet"},
         "queries": ["q0.sql", "select 2 as y", ["q0.sql", "select 3"]],
         "answers": "ans"}
    (tmp_path / "m.json").write_text(json.dumps(m))
    loaded = Manifest.load(str(tmp_path / "m.json"))
    assert loaded.queries == ["select 1 as x", "select 2 as y",
                              ["select 1 as x", "select 3"]]
    assert loaded.tables == {"a": str(tmp_path / "a.parquet")}
    assert loaded.answers == str(tmp_path / "ans")
    from liquid_tpu.bench.manifest import Manifest as JManifest
    assert loaded.__dict__ == JManifest.load(
        str(tmp_path / "m.json")).__dict__


def test_inprocess_runner_modes(tiny_manifest, tmp_path):
    mp, _d, paths = tiny_manifest
    m = Manifest.load(mp)
    want = oracle.answers(paths, ["tpch_q1", "tpch_q6"])
    out_by_mode = {}
    for mode in ("liquid", "arrow", "liquid-no-squeeze"):
        r = InProcessRunner(m, mode=mode, iterations=2, device="cpu",
                            cache_dir=str(tmp_path / mode))
        assert r.cache.device.type == "cpu"
        res = r.run()
        assert res["mode"] == mode
        assert len(res["queries"]) == 3
        for q in res["queries"]:
            assert q["best_ms"] > 0
            assert len(q["iterations"]) == 2
            assert {"user_cpu_s", "max_rss_kb", "disk_read_bytes"} <= set(
                q["iterations"][0])
        assert oracle.same_table(r._run_one(m.queries[0]), want["tpch_q1"])
        assert oracle.same_table(r._run_one(m.queries[1]), want["tpch_q6"])
        out_by_mode[mode] = res
    # liquid mode transcodes; arrow mode must not
    assert out_by_mode["liquid"]["cache_stats"]["transcodes"] > 0
    assert out_by_mode["arrow"]["cache_stats"]["transcodes"] == 0


def test_answers_roundtrip_verification(tiny_manifest, answers_dir, tmp_path):
    mp, _d, paths = tiny_manifest
    m = Manifest.load(mp)
    m.answers = answers_dir
    # the stored answers are pyarrow's
    assert oracle.same_table(pq.read_table(f"{answers_dir}/q1.parquet"),
                             oracle.answers(paths, ["tpch_q6"])["tpch_q6"])
    # the arrow mode (the classic route) verifies against them
    r = InProcessRunner(m, mode="arrow", iterations=1, device="cpu",
                        cache_dir=str(tmp_path / "verify"))
    res = r.run(verify=True)
    assert [q["verified"] for q in res["queries"]] == [True, True, True]
    # a wrong answer does not verify
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    t = pq.read_table(f"{answers_dir}/q2.parquet")
    pq.write_table(t.set_column(0, "c", [[t.column(0)[0].as_py() + 1]]),
                   f"{bad}/q2.parquet")
    m.answers = bad
    assert [q["verified"] for q in r.run()["queries"]] == [None, None, False]


def test_runner_writes_results(tiny_manifest, tmp_path):
    mp, _d, _paths = tiny_manifest
    m = Manifest.load(mp)
    r = InProcessRunner(m, iterations=1, device="cpu",
                        cache_dir=str(tmp_path / "c"))
    res = r.run(verify=False)
    out = str(tmp_path / "results.json")
    r.write_results(out, res)
    with open(out) as f:
        assert json.load(f)["manifest"] == "tpch-tiny"


def test_server_mode_benchmark_client(tiny_manifest, answers_dir, tmp_path):
    from liquid_tpu_torch.bench.clients import BenchmarkClient, serve
    mp, _d, _paths = tiny_manifest
    m = Manifest.load(mp)
    m.answers = answers_dir
    srv, admin = serve(cache_mode="liquid", max_memory_mb=256,
                       disk_cache_dir=str(tmp_path / "srv"),
                       port=0, admin_port=0, block=False, device="cpu")
    try:
        assert srv.inner.cache.device.type == "cpu"
        assert srv.inner.ctx.cache is srv.inner.cache
        host, port = srv.addr
        c = BenchmarkClient(m, host, port, admin=admin.addr, iterations=2,
                            cache_trace_dir=str(tmp_path / "traces"),
                            flamegraph_dir=str(tmp_path / "flame"))
        res = c.run(verify=True)
        assert len(res["queries"]) == 3
        assert [q["verified"] for q in res["queries"]] == [True, True, True]
        assert res["server_cache_stats"]["inserts"] > 0
        # cache traces and flamegraphs were written per query
        assert os.path.exists(str(tmp_path / "traces" / "q0.parquet"))
        assert os.path.exists(str(tmp_path / "flame" / "q2.folded"))
    finally:
        srv.stop()
        admin.stop()


def test_cli_in_process(tiny_manifest, tmp_path):
    from liquid_tpu_torch.bench.clients import main
    mp, _d, _paths = tiny_manifest
    out = str(tmp_path / "r.json")
    rc = main(["in-process", "--manifest", mp, "--iterations", "1",
               "--device", "cpu", "--output", out])
    assert rc == 0
    with open(out) as f:
        res = json.load(f)
    assert len(res["queries"]) == 3 and res["mode"] == "liquid"


def test_cli_client_against_a_server(tiny_manifest, tmp_path, capsys):
    from liquid_tpu_torch.bench.clients import main, serve
    mp, _d, _paths = tiny_manifest
    srv, admin = serve(max_memory_mb=64, disk_cache_dir=str(tmp_path / "s"),
                       port=0, admin_port=0, block=False, device="cpu")
    addrs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    try:
        assert tuple(addrs["flight"]) == srv.addr
        rc = main(["client", "--manifest", mp, "--port",
                   str(srv.addr[1]), "--admin-port", str(admin.addr[1]),
                   "--iterations", "1", "--partitions", "2"])
        assert rc == 0
        res = json.loads(capsys.readouterr().out)
        assert [q["iterations"][0]["rows"] for q in res["queries"]] == \
            [4, 1, 1]
        assert res["server_cache_stats"]["inserts"] > 0
    finally:
        srv.stop()
        admin.stop()


def test_clickbench_manifest_loads():
    from liquid_tpu.bench.manifest import Manifest as JManifest
    mp = os.path.join(ROOT, "benchmark", "clickbench", "manifest.json")
    m = Manifest.load(mp)
    assert len(m.queries) == 43
    assert "hits" in m.tables
    assert m.__dict__ == JManifest.load(mp).__dict__


def test_tracepoints(tmp_path, monkeypatch):
    from liquid_tpu_torch.bench import tracepoints
    seen = []
    monkeypatch.setattr(tracepoints, "_subscribers", [])
    tracepoints.subscribe(lambda b, q: seen.append((b, q)))
    monkeypatch.setattr(tracepoints, "TRACE_PATH", str(tmp_path / "tp.log"))
    tracepoints.iteration_start("tpch", 5)
    assert seen == [("tpch", 5)]
    assert "iteration_start tpch 5" in (tmp_path / "tp.log").read_text()
