"""The compute node's client of the cache server (port of
`liquid_tpu/server/client.py`).

Reference behavior: `LiquidCacheClientBuilder` and
`LiquidCacheClientExec` (liquid-cache `src/datafusion-client/src/
lib.rs:50-140`, `client_exec.rs:41-299`): the client registers a query's
plan once, behind a three-state latch shared by its threads, then opens
one Flight stream per partition and decodes the record batches,
recording stream metrics.  The pushed plan is the whole SQL text, since
the server runs the whole engine (reference `:1-15`).

Where the port departs from the reference on purpose:
- a partition whose stream fails makes `sql()` raise (the reference
  loses that partition's rows without a word);
- the stream metrics of concurrent partitions are counted per partition
  and summed after the join: time to first batch is the earliest
  partition's, from the start of `sql()`;
- an answer without rows keeps the stream's schema (the reference
  returns a table without columns);
- a plan handle the server no longer holds (its cache was reset, by this
  client's `reset_cache` or by another) is answered: `reset_cache`
  forgets this client's handles, and a fetch that meets the server's
  `rpc.UNKNOWN_HANDLE` error registers its query again, once, and
  fetches again; a second failure is raised.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import asdict
from typing import Dict, List, Optional, Tuple

import pyarrow as pa
import pyarrow.flight as fl

from liquid_tpu_torch.common import rpc
from liquid_tpu_torch.utils.tracing import TRACER

#: the registration latch's states (reference `:29`)
UNREGISTERED, REGISTERING, REGISTERED = 0, 1, 2


class StalePlanHandle(RuntimeError):
    """The server holds no plan under the handle a fetch sent."""


class FlightStreamMetrics:
    """Client-side stream timing of one `sql()` call (reference `:32-39`)."""

    def __init__(self):
        self.time_to_first_batch_ms = 0.0
        self.total_stream_ms = 0.0
        self.batches = 0
        self.rows = 0


class LiquidCacheClient:
    def __init__(self, host: str, port: int,
                 tables: Optional[Dict[str, str]] = None,
                 partitions: int = 1):
        self.addr = (host, port)
        self.tables = dict(tables or {})
        self.partitions = partitions
        self._latch: Dict[str, int] = {}
        self._handles: Dict[str, str] = {}
        self._latch_cv = threading.Condition()
        #: plans this client has registered with the server, a query
        #: registered again after a reset included
        self.registrations = 0
        self.last_metrics: Optional[FlightStreamMetrics] = None
        self._flight = None
        self._conn_lock = threading.Lock()

    def _conn(self):
        # one shared channel without TLS; a FlightClient is thread-safe
        with self._conn_lock:
            if self._flight is None:
                self._flight = fl.connect(
                    f"grpc://{self.addr[0]}:{self.addr[1]}")
            return self._flight

    def close(self) -> None:
        with self._conn_lock:
            if self._flight is not None:
                self._flight.close()
                self._flight = None

    def _call(self, action_type: str, msg: dict) -> dict:
        try:
            res = list(self._conn().do_action(
                fl.Action(action_type, json.dumps(msg).encode())))
        except (fl.FlightError, pa.ArrowException) as ex:
            raise RuntimeError(f"server error: {ex}") from ex
        return json.loads(res[0].body.to_pybytes()) if res else {}

    def register_object_store(self, url: str, options: dict = None) -> None:
        self._call("register_object_store", asdict(
            rpc.RegisterObjectStoreRequest(url, options or {})))

    def register_table(self, name: str, location: str) -> None:
        self.tables[name] = location

    def prefetch(self, url: str, location: str, rng=None) -> int:
        out = self._call("prefetch", asdict(rpc.PrefetchRequest(
            url, location, list(rng) if rng else None)))
        return out["bytes"]

    def _ensure_registered(self, sql: str) -> str:
        """Register the plan exactly once across threads (the three-state
        latch, reference `:87-116`)."""
        with self._latch_cv:
            while self._latch.get(sql) == REGISTERING:
                self._latch_cv.wait()
            if self._latch.get(sql) == REGISTERED:
                return self._handles[sql]
            self._latch[sql] = REGISTERING
        try:
            handle = str(uuid.uuid4())
            self._call("register_plan",
                       {**asdict(rpc.RegisterPlanRequest(
                           sql, handle, self.tables)),
                        "partitions": self.partitions})
            with self._latch_cv:
                self._handles[sql] = handle
                self._latch[sql] = REGISTERED
                self.registrations += 1
                self._latch_cv.notify_all()
            return handle
        except BaseException:
            with self._latch_cv:
                self._latch[sql] = UNREGISTERED
                self._latch_cv.notify_all()
            raise

    def _fetch_partition(self, handle: str, partition: int, t0: float,
                         traceparent: str) -> tuple:
        """One partition's stream -> (its schema, its batches, its
        metrics; time to first batch counted from `t0`)."""
        m = FlightStreamMetrics()
        batches: List[pa.RecordBatch] = []
        ticket = fl.Ticket(json.dumps(asdict(rpc.FetchResults(
            handle, partition, traceparent))).encode())
        try:
            reader = self._conn().do_get(ticket)
            for chunk in reader:
                if not batches:
                    m.time_to_first_batch_ms = (
                        (time.perf_counter() - t0) * 1000)
                batches.append(chunk.data)
                m.batches += 1
                m.rows += chunk.data.num_rows
        except (fl.FlightError, pa.ArrowException) as ex:
            if rpc.UNKNOWN_HANDLE in str(ex):
                raise StalePlanHandle(f"server error: {ex}") from ex
            raise RuntimeError(f"server error: {ex}") from ex
        return reader.schema, batches, m

    def _forget(self, handles=None) -> None:
        """Drop the registrations of `handles`, every one by default: their
        queries register again on their next use."""
        with self._latch_cv:
            for sql in [s for s, h in self._handles.items()
                        if handles is None or h in handles]:
                del self._handles[sql]
                self._latch.pop(sql, None)

    def sql(self, query: str) -> pa.Table:
        with TRACER.span("client.sql", query=query[:120]):
            return self._sql_inner(query)

    def _sql_inner(self, query: str) -> pa.Table:
        handle = self._ensure_registered(query)
        try:
            return self._fetch(handle)
        except StalePlanHandle:
            self._forget({handle})
            return self._fetch(self._ensure_registered(query))

    def _fetch(self, handle: str) -> pa.Table:
        """Every partition of a registered plan, as one table."""
        t0 = time.perf_counter()
        tp = TRACER.current_traceparent()  # on the caller's thread
        results: list = [None] * self.partitions
        errors: list = []
        if self.partitions == 1:
            results[0] = self._fetch_partition(handle, 0, t0, tp)
        else:
            def work(i):
                try:
                    results[i] = self._fetch_partition(handle, i, t0, tp)
                except BaseException as ex:  # raised after the join
                    errors.append(ex)
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(self.partitions)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                raise next((e for e in errors
                            if not isinstance(e, StalePlanHandle)),
                           errors[0])
        metrics = FlightStreamMetrics()
        all_batches: List[pa.RecordBatch] = []
        firsts = []
        for schema, batches, m in results:
            all_batches.extend(batches)
            metrics.batches += m.batches
            metrics.rows += m.rows
            if m.batches:
                firsts.append(m.time_to_first_batch_ms)
        metrics.time_to_first_batch_ms = min(firsts, default=0.0)
        metrics.total_stream_ms = (time.perf_counter() - t0) * 1000
        self.last_metrics = metrics
        return pa.Table.from_batches(all_batches, schema)

    def execution_metrics(self, sql: Optional[str] = None
                          ) -> rpc.ExecutionMetricsResponse:
        handle = self._handles.get(sql, "") if sql else ""
        out = self._call("execution_metrics", {"handle": handle})
        return rpc.ExecutionMetricsResponse(**out["metrics"])

    def server_stats(self) -> dict:
        return self._call("stats", {})["stats"]

    def reset_cache(self) -> None:
        """Reset the server's cache and plans; this client's handles go
        with them."""
        self._call("reset", {})
        self._forget()


class LiquidCacheClientBuilder:
    """Fluent construction of a client (reference `:191-221`)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host, self._port = host, port
        self._tables: Dict[str, str] = {}
        self._stores: List[Tuple[str, dict]] = []
        self._partitions = 1

    def with_server(self, host: str, port: int):
        self._host, self._port = host, port
        return self

    def with_object_store(self, url: str, options: dict = None):
        self._stores.append((url, options or {}))
        return self

    def with_parquet_table(self, name: str, location: str):
        self._tables[name] = location
        return self

    def with_partitions(self, n: int):
        self._partitions = n
        return self

    def build(self) -> LiquidCacheClient:
        c = LiquidCacheClient(self._host, self._port, self._tables,
                              self._partitions)
        for url, options in self._stores:
            c.register_object_store(url, options)
        return c
