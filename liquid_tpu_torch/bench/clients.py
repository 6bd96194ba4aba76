"""Server-mode benchmark binaries: the cache server and the
manifest-driven client (port of `liquid_tpu/bench/clients.py`).

Reference behavior: `benchmark/bench_server.rs:15-62` (--cache-mode
{arrow, liquid, liquid-no-squeeze}, --max-memory-mb, --disk-cache-dir,
--address, --abort-on-panic) and the Flight clients
`clickbench_client.rs` / `tpch_client.rs` / `tpcds_client.rs`: per-query
iterations, answers checked against stored parquet answers, cache traces
and flamegraphs through the admin API.  `serve` and the CLI also take
the device the server's engine runs on (`--device`, default `cuda`).

    python -m liquid_tpu_torch.bench.clients server --cache-mode liquid \
        --max-memory-mb 16384
    python -m liquid_tpu_torch.bench.clients client --manifest m.json
    python -m liquid_tpu_torch.bench.clients in-process --manifest m.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request
from typing import Optional

from liquid_tpu_torch.bench import tracepoints
from liquid_tpu_torch.bench.manifest import Manifest
from liquid_tpu_torch.bench.runner import MODES, make_session


def _default_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def serve(cache_mode: str = "liquid", max_memory_mb: int = 1024,
          disk_cache_dir: Optional[str] = None,
          address: str = "127.0.0.1", port: int = 50051,
          admin_port: int = 8080, block: bool = True, device="cuda"):
    """Start the cache server and its admin server on a session of
    `cache_mode` on `device` (reference `:29-60`).  It prints one JSON
    line of both addresses; `block=False` returns (service, admin), else
    it serves until `/shutdown` or Ctrl-C."""
    from liquid_tpu_torch.server import AdminServer, LiquidCacheService
    disk_cache_dir = disk_cache_dir or _default_dir("liquid_tpu_torch_server")
    os.makedirs(disk_cache_dir, exist_ok=True)
    ctx, cache = make_session(cache_mode, max_memory_mb << 20,
                              disk_cache_dir, device)
    srv = LiquidCacheService(cache, host=address, port=port,
                             byte_cache_dir=os.path.join(disk_cache_dir, "bc"))
    srv.inner.ctx = ctx  # the session with the mode's policies
    host, fport = srv.start()
    stop = {"flag": False}

    def on_shutdown():
        stop["flag"] = True
        srv.stop()
        admin.stop()

    admin = AdminServer(srv.inner, host=address, port=admin_port,
                        on_shutdown=on_shutdown)
    ahost, aport = admin.start()
    print(json.dumps({"flight": [host, fport], "admin": [ahost, aport]}),
          flush=True)
    if not block:
        return srv, admin
    try:
        while not stop["flag"]:
            time.sleep(0.25)
    except KeyboardInterrupt:
        on_shutdown()
    return None


class BenchmarkClient:
    """Manifest-driven client (reference `:63-147`)."""

    def __init__(self, manifest: Manifest, host: str, port: int,
                 admin: Optional[tuple] = None, iterations: int = 3,
                 partitions: int = 1, cache_trace_dir: Optional[str] = None,
                 flamegraph_dir: Optional[str] = None):
        from liquid_tpu_torch.server import LiquidCacheClientBuilder
        b = LiquidCacheClientBuilder(host, port).with_partitions(partitions)
        for name, path in manifest.tables.items():
            b = b.with_parquet_table(name, path)
        for st in manifest.object_stores:
            b = b.with_object_store(st["url"], st.get("options", {}))
        self.client = b.build()
        self.manifest = manifest
        self.admin = admin
        self.iterations = iterations
        self.cache_trace_dir = cache_trace_dir
        self.flamegraph_dir = flamegraph_dir

    def _admin(self, path: str) -> object:
        host, port = self.admin
        with urllib.request.urlopen(f"http://{host}:{port}{path}") as r:
            body = r.read()
        try:
            return json.loads(body)
        except ValueError:
            return body.decode()

    def run(self, verify: bool = True) -> dict:
        results = []
        for qi, sql in enumerate(self.manifest.queries):
            if isinstance(sql, list):
                sql = sql[0] if len(sql) == 1 else sql
            tracepoints.iteration_start(self.manifest.name, qi)
            if self.admin and self.cache_trace_dir:
                self._admin("/start_trace")
            if self.admin and self.flamegraph_dir:
                self._admin("/start_flamegraph")
            iters, out = [], None
            for _ in range(self.iterations):
                t0 = time.perf_counter()
                out = (self.client.sql(sql) if isinstance(sql, str)
                       else self._run_stmts(sql))
                iters.append({"ms": (time.perf_counter() - t0) * 1000,
                              "rows": out.num_rows})
            if self.admin and self.flamegraph_dir:
                folded = self._admin("/stop_flamegraph")
                os.makedirs(self.flamegraph_dir, exist_ok=True)
                with open(os.path.join(self.flamegraph_dir,
                                       f"q{qi}.folded"), "w") as f:
                    f.write(folded if isinstance(folded, str) else "")
            if self.admin and self.cache_trace_dir:
                os.makedirs(self.cache_trace_dir, exist_ok=True)
                self._admin("/stop_trace?path=" + os.path.join(
                    self.cache_trace_dir, f"q{qi}.parquet"))
            verified = self._verify(qi, out) if verify else None
            results.append({"query": qi, "best_ms": min(i["ms"] for i in iters),
                            "iterations": iters, "verified": verified})
        metrics = None
        if self.admin:
            metrics = self._admin("/cache_stats")
        return {"manifest": self.manifest.name, "queries": results,
                "server_cache_stats": metrics}

    def _run_stmts(self, stmts):
        import pyarrow as pa
        out = pa.table({})
        for s in stmts:
            r = self.client.sql(s)
            if r.num_columns:
                out = r
        return out

    def _verify(self, qi: int, out) -> Optional[bool]:
        if self.manifest.answers is None:
            return None
        import pyarrow.parquet as pq
        path = os.path.join(self.manifest.answers, f"q{qi}.parquet")
        if not os.path.exists(path):
            return None
        expect = pq.read_table(path)
        return out.num_rows == expect.num_rows and \
            out.rename_columns(expect.column_names).to_pylist() == \
            expect.to_pylist()


def _emit(res: dict, output: Optional[str]) -> None:
    out = json.dumps(res, indent=2, default=str)
    if output:
        with open(output, "w") as f:
            f.write(out)
    else:
        print(out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="liquid-tpu-torch-bench")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("server")
    ps.add_argument("--cache-mode", default="liquid", choices=MODES)
    ps.add_argument("--max-memory-mb", type=int, default=1024)
    ps.add_argument("--disk-cache-dir", default=None)
    ps.add_argument("--address", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=50051)
    ps.add_argument("--admin-port", type=int, default=8080)
    ps.add_argument("--abort-on-panic", action="store_true")
    ps.add_argument("--device", default="cuda")
    pc = sub.add_parser("client")
    pc.add_argument("--manifest", required=True)
    pc.add_argument("--host", default="127.0.0.1")
    pc.add_argument("--port", type=int, default=50051)
    pc.add_argument("--admin-port", type=int, default=None)
    pc.add_argument("--iterations", type=int, default=3)
    pc.add_argument("--partitions", type=int, default=1)
    pc.add_argument("--cache-trace-dir", default=None)
    pc.add_argument("--flamegraph-dir", default=None)
    pc.add_argument("--output", default=None)
    pi = sub.add_parser("in-process")
    pi.add_argument("--manifest", required=True)
    pi.add_argument("--cache-mode", default="liquid", choices=MODES)
    pi.add_argument("--max-memory-mb", type=int, default=1024)
    pi.add_argument("--iterations", type=int, default=3)
    pi.add_argument("--output", default=None)
    pi.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.cmd == "server":
        serve(args.cache_mode, args.max_memory_mb, args.disk_cache_dir,
              args.address, args.port, args.admin_port, device=args.device)
        return 0
    if args.cmd == "client":
        m = Manifest.load(args.manifest)
        admin = ((args.host, args.admin_port)
                 if args.admin_port is not None else None)
        c = BenchmarkClient(m, args.host, args.port, admin=admin,
                            iterations=args.iterations,
                            partitions=args.partitions,
                            cache_trace_dir=args.cache_trace_dir,
                            flamegraph_dir=args.flamegraph_dir)
        _emit(c.run(), args.output)
        return 0
    if args.cmd == "in-process":
        from liquid_tpu_torch.bench.runner import InProcessRunner
        m = Manifest.load(args.manifest)
        r = InProcessRunner(m, mode=args.cache_mode,
                            max_memory_bytes=args.max_memory_mb << 20,
                            iterations=args.iterations, device=args.device)
        _emit(r.run(), args.output)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
