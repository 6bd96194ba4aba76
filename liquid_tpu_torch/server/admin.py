"""The admin HTTP server: cache introspection and control (port of
`liquid_tpu/server/admin.py`).

Reference behavior: the admin server of liquid-cache
(`src/datafusion-server/src/admin_server/mod.rs:58-86`) with the routes
/shutdown /reset_cache /parquet_cache_usage /cache_info /system_info
/start_trace /stop_trace /execution_metrics /execution_plans
/cache_stats /start_flamegraph /stop_flamegraph /add_execution_stats
/start_disk_usage_monitor /stop_disk_usage_monitor (reference
`:140-214`); the flamegraph is a sampling profiler over
`sys._current_frames()` that emits folded stacks
(`admin_server/flamegraph.rs:1-43`), and a background thread samples the
cache directory's disk usage (`disk_monitor.rs:27-92`).  It serves on
the standard library's `ThreadingHTTPServer`; `stop()` ends it within a
time limit or raises.  `/execution_plans` marks a plan executed once it
has run (the reference marks a partitionable scan, whose result is never
kept, as never executed).
"""
from __future__ import annotations

import collections
import json
import os
import platform
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import pyarrow.flight as fl

from liquid_tpu_torch.common import rpc
from liquid_tpu_torch.server.flight import STOP_TIMEOUT_S, _stop_within


class Flamegraph:
    """A sampling profiler of every other thread's stack -> folded stacks
    (Brendan Gregg's format, one `frame;frame;... count` line each)."""

    def __init__(self, hz: int = 200):
        self.hz = hz
        self._counts: collections.Counter = collections.Counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._counts.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        me = threading.get_ident()
        period = 1.0 / self.hz
        while not self._stop.is_set():
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = []
                f = frame
                while f is not None:
                    stack.append(f"{f.f_code.co_filename.rsplit('/', 1)[-1]}"
                                 f":{f.f_code.co_name}")
                    f = f.f_back
                self._counts[";".join(reversed(stack))] += 1
            time.sleep(period)

    def stop(self) -> str:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        return "\n".join(f"{k} {v}" for k, v in self._counts.most_common())


class DiskMonitor:
    """A background thread sampling the bytes under a directory."""

    def __init__(self, path: str, interval_s: float = 1.0):
        self.path = path
        self.interval_s = interval_s
        self.samples: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _usage(self) -> int:
        total = 0
        for root, _dirs, files in os.walk(self.path):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        return total

    def start(self) -> None:
        self._stop.clear()
        self.samples = []

        def run():
            while not self._stop.is_set():
                self.samples.append((time.time(), self._usage()))
                self._stop.wait(self.interval_s)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> list:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        return self.samples


class AdminServer:
    def __init__(self, inner, host: str = "127.0.0.1", port: int = 0,
                 on_shutdown=None):
        self.inner = inner           # LiquidCacheServiceInner
        self.flamegraph = Flamegraph()
        self.disk_monitor: Optional[DiskMonitor] = None
        self.on_shutdown = on_shutdown
        admin = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _text(self, s: str, code=200):
                body = s.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                self.do_GET()

            def do_GET(self):  # noqa: C901 - route table
                u = urlparse(self.path)
                route = u.path.rstrip("/")
                q = parse_qs(u.query)
                inner = admin.inner
                if route == "/shutdown":
                    self._json({"ok": True})
                    if admin.on_shutdown:
                        threading.Thread(target=admin.on_shutdown,
                                         daemon=True).start()
                elif route == "/reset_cache":
                    inner.reset()
                    self._json({"ok": True})
                elif route == "/cache_stats":
                    self._json(inner.cache.stats())
                elif route == "/cache_info":
                    b = inner.cache.budget
                    self._json({
                        "batch_size": inner.cache.batch_size,
                        "max_cache_bytes": b.max_memory_bytes,
                        "memory_usage_bytes": b.memory_used,
                        "disk_usage_bytes": b.disk_used,
                        "entries": inner.cache.stats()["entries"]})
                elif route == "/parquet_cache_usage":
                    self._json({"memory_used": inner.cache.budget.memory_used,
                                "disk_used": inner.cache.budget.disk_used})
                elif route == "/system_info":
                    self._json({
                        "platform": platform.platform(),
                        "python": sys.version.split()[0],
                        "pid": os.getpid(),
                        "cpu_count": os.cpu_count(),
                        "threads": threading.active_count()})
                elif route == "/start_trace":
                    inner.cache.observer.start_trace()
                    self._json({"ok": True})
                elif route == "/stop_trace":
                    path = q.get("path", [None])[0]
                    if path:
                        n = inner.cache.observer.flush_trace_parquet(path)
                        self._json({"ok": True, "flushed": n, "path": path})
                    else:
                        recs = inner.cache.observer.stop_trace()
                        self._json({"ok": True,
                                    "trace": [r.__dict__ for r in recs]})
                elif route == "/execution_metrics":
                    try:
                        m = inner.metrics(q.get("handle", [""])[0])
                    except fl.FlightServerError as e:
                        if rpc.UNKNOWN_HANDLE not in str(e):
                            raise
                        self._json({"error": str(e)}, 404)
                    else:
                        self._json(m.__dict__)
                elif route == "/execution_plans":
                    self._json({h: {"sql": e["sql"],
                                    "partitions": e["partitions"],
                                    "executed": e["runs"] > 0,
                                    "eval_ms": e["eval_ms"]}
                                for h, e in inner.plans.items()})
                elif route == "/add_execution_stats":
                    ln = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(ln) or b"{}")
                    inner.execution_stats.append(payload)
                    self._json({"ok": True})
                elif route == "/start_flamegraph":
                    admin.flamegraph.start()
                    self._json({"ok": True})
                elif route == "/stop_flamegraph":
                    self._text(admin.flamegraph.stop())
                elif route == "/start_disk_usage_monitor":
                    path = q.get("path", [inner.byte_cache_dir or "/tmp"])[0]
                    admin.disk_monitor = DiskMonitor(path)
                    admin.disk_monitor.start()
                    self._json({"ok": True})
                elif route == "/stop_disk_usage_monitor":
                    samples = (admin.disk_monitor.stop()
                               if admin.disk_monitor else [])
                    self._json({"samples": samples})
                else:
                    self._json({"error": f"unknown route {route}"}, 404)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.addr: Tuple[str, int] = self._srv.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.addr

    def stop(self, timeout: float = STOP_TIMEOUT_S) -> None:
        """End the server within `timeout` seconds or raise (`shutdown`
        would wait for ever on a server that never served)."""
        try:
            if self._thread is not None:
                _stop_within("the admin server", self._srv.shutdown,
                             self._thread, timeout)
        finally:
            self._srv.server_close()
