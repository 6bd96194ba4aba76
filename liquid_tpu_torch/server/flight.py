"""The cache server: SQL in, Arrow record batches out, over Arrow Flight
(port of `liquid_tpu/server/flight.py`).

Reference behavior: `LiquidCacheService` + `LiquidCacheServiceInner`
(liquid-cache `src/datafusion-server/src/lib.rs:102-349`,
`service.rs:38-214`).  DoAction registers object stores (remote ones
wrapped in the byte cache) and plans under client-chosen handles, and
answers prefetch, metrics, reset and stats; DoGet of a `FetchResults`
ticket executes one partition of a plan and streams its record batches.
The shipped plan is the SQL text and its table registrations, as in the
reference (`:1-17`).

Execution runs the port's engine on the cache's device (`QueryExecutor(
tables, cache.device)`): the card unless the cache was built for the
CPU.
- A plain single-table scan (`_partitionable_scan`) executes per
  partition, one row group at a time, each through a `_RowGroupSlice` of
  the table, and streams each row group's rows as it is produced
  (reference `:185-212`).  It executes again on every fetch.
- Any other plan executes once, on its first fetch; its result is kept
  with the plan and sliced per partition, so a repeated fetch re-streams
  it without touching the engine (reference `:214-228`).
- The engine is not re-entrant (its plan memos, route counters and
  kernel launch counts are plain dicts): partition streams run on their
  own gRPC threads and interleave, but each engine call holds the
  service's engine lock, so one row group or plan executes at a time.
- A server-side error fails the fetch; the client raises it.  A handle
  the service does not hold (`reset` clears the plans) fails with a
  Flight error that names it (`rpc.UNKNOWN_HANDLE`); the client then
  registers its query again.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional, Tuple

import pyarrow as pa
import pyarrow.flight as fl

from liquid_tpu_torch.common import rpc
from liquid_tpu_torch.common.object_store import (
    ByteCache, LocalStore, MockStore, ObjectStore, StoreFile, sanitize_url,
)
from liquid_tpu_torch.sql import ast
from liquid_tpu_torch.sql.exec import QueryExecutor, _contains
from liquid_tpu_torch.sql.fused_agg import table_state
from liquid_tpu_torch.sql.parser import parse_statement
from liquid_tpu_torch.sql.physical import find_aggs
from liquid_tpu_torch.sql.session import SessionContext
from liquid_tpu_torch.utils.tracing import TRACER

#: seconds `stop()` waits for a server to end before it raises
STOP_TIMEOUT_S = 30.0


class _RowGroupSlice:
    """A parquet table seen through a set of its row groups: the unit a
    partition executes (reference `:37-58`).  Reads and zone-prune counts
    go to the base table, which shares its cache and zone maps.  Its
    fused-route state is derived from the base's
    (`fused_agg.TableState.derive`): the block-keyed preps and builds
    are the base's own, its plans are not."""

    def __init__(self, base, rgs):
        self._base = base
        self._rgs = frozenset(rgs)
        self.route_state = table_state(base).derive("slice")

    def prune_row_groups(self, preds):
        keep = self._base.prune_row_groups(preds)
        return [rg for rg in keep if rg in self._rgs]

    @property
    def zone_prunes(self):
        return self._base.zone_prunes

    @zone_prunes.setter
    def zone_prunes(self, v):
        self._base.zone_prunes = v

    def __getattr__(self, k):
        return getattr(self._base, k)


def _has_subquery(e) -> bool:
    return _contains(e, (ast.Subquery, ast.InSubquery, ast.Exists))


def _has_window(e) -> bool:
    return _contains(e, ast.WindowFunc)


def _partitionable_scan(sql: str, tables) -> Optional[str]:
    """The table's name when `sql` is a plain scan of one registered table
    whose rows decompose by row group (no aggregate, GROUP BY, HAVING,
    ORDER BY, LIMIT, OFFSET, DISTINCT, CTE, join, set operation, window or
    subquery), else None (reference `:61-108`)."""
    try:
        stmt = parse_statement(sql)
    except Exception:  # the engine reports the error when it runs
        return None
    if stmt[0] != "select" or not isinstance(stmt[1], ast.Select):
        return None
    q = stmt[1]
    if (q.ctes or q.group_by or q.having or q.order_by
            or q.limit is not None or q.offset is not None or q.distinct):
        return None
    if not isinstance(q.from_, ast.TableRef) or q.from_.name not in tables:
        return None
    # a subquery must see the whole table, not one partition's slice
    if q.where is not None and _has_subquery(q.where):
        return None
    aggs: list = []
    for it in q.items:
        find_aggs(it.expr, aggs)
        if _has_window(it.expr) or _has_subquery(it.expr):
            return None
    return None if aggs else q.from_.name


class LiquidCacheServiceInner:
    """The plan and object-store registries around one cache and session
    (reference `:111-252`)."""

    def __init__(self, cache, byte_cache_dir: Optional[str] = None):
        self.cache = cache
        self.ctx = SessionContext(cache)
        self.byte_cache_dir = byte_cache_dir
        self.stores: Dict[str, ObjectStore] = {}
        #: handle -> {sql, partitions, result (pa.Table | None), eval_ms,
        #: scan_table, runs (executions so far), lock}
        self.plans: Dict[str, dict] = {}
        self.execution_stats: list = []
        self._lock = threading.Lock()
        #: held by every engine call (module doc)
        self._engine = threading.Lock()

    # -- object stores ---------------------------------------------------------

    def register_object_store(self, url: str, options: dict) -> None:
        with self._lock:
            if url in self.stores:
                return
            if url.startswith("mock://"):
                store: ObjectStore = MockStore(
                    {k: v.encode("latin1") for k, v in
                     options.get("objects", {}).items()})
            elif url.startswith("file://") or url == "local":
                store = LocalStore(options.get("root", "/"))
            else:
                raise ValueError(f"unsupported object store {url!r}")
            if self.byte_cache_dir and not url.startswith("file://") \
                    and url != "local":
                # every remote store reads through the byte cache
                store = ByteCache(
                    store, f"{self.byte_cache_dir}/{sanitize_url(url)}")
            self.stores[url] = store

    def store_for(self, url: str) -> ObjectStore:
        return self.stores[url]

    def _register_table(self, name: str, location: str) -> None:
        """`location` is a local path, or `<store url>!<object path>`."""
        if name in self.ctx._tables:
            return
        url, _, path = location.partition("!")
        if not path:
            self.ctx.register_parquet(name, url)
            return
        store = self.stores[url]
        self.ctx.register_parquet(
            name, f"{url}/{path}",
            open_file=lambda s=store, p=path: StoreFile(s, p))

    # -- plans -------------------------------------------------------------------

    def register_plan(self, sql: str, handle: str, tables: Dict[str, str],
                      partitions: int = 1) -> None:
        for name, loc in tables.items():
            self._register_table(name, loc)
        scan_of = _partitionable_scan(sql, self.ctx._tables)
        with self._lock:
            if handle not in self.plans:
                self.plans[handle] = {"sql": sql, "partitions": partitions,
                                      "result": None, "eval_ms": 0,
                                      "scan_table": scan_of, "runs": 0,
                                      "lock": threading.Lock()}

    def _partition_rgs(self, table, partition: int, n: int):
        """The contiguous row-group range of one partition (contiguity
        keeps the partitions' concatenation in the full scan's order)."""
        nrg = table.num_row_groups
        per = (nrg + n - 1) // n
        return list(range(partition * per, min((partition + 1) * per, nrg)))

    def _execute_slice(self, sql: str, name: str, base, rgs) -> pa.Table:
        with self._engine:  # the slice may make the base's route state
            tables = {**self.ctx._tables, name: _RowGroupSlice(base, rgs)}
            return QueryExecutor(tables, self.cache.device).execute_sql(sql)

    def _plan(self, handle: str) -> dict:
        ent = self.plans.get(handle)
        if ent is None:
            raise fl.FlightServerError(
                f"{rpc.UNKNOWN_HANDLE} {handle!r}: the server holds no such "
                f"plan (reset or never registered); register it again")
        return ent

    def execute_partition_stream(self, handle: str, partition: int):
        """Yield one partition's result in pieces: a partitionable scan one
        table per row group, each executed only when the previous one has
        been taken; any other plan its slice of the whole result."""
        ent = self._plan(handle)
        name = ent.get("scan_table")
        if name is None:
            yield self.execute_partition(handle, partition)
            return
        base = self.ctx._tables[name]
        t0 = time.perf_counter()
        rgs = self._partition_rgs(base, partition, ent["partitions"])
        for rg in rgs:
            yield self._execute_slice(ent["sql"], name, base, [rg])
        if not rgs:  # an empty partition still streams a typed schema
            yield self._execute_slice(ent["sql"], name, base, [])
        with ent["lock"]:
            ent["eval_ms"] += int((time.perf_counter() - t0) * 1000)
            ent["runs"] += 1

    def execute_partition(self, handle: str, partition: int) -> pa.Table:
        ent = self._plan(handle)
        if ent.get("scan_table") is not None:
            parts = list(self.execute_partition_stream(handle, partition))
            return pa.concat_tables(parts, promote_options="permissive")
        with ent["lock"]:
            if ent["result"] is None:
                t0 = time.perf_counter()
                with self._engine:
                    ent["result"] = self.ctx.sql(ent["sql"]).to_arrow()
                ent["eval_ms"] = int((time.perf_counter() - t0) * 1000)
                ent["runs"] += 1
        t = ent["result"]
        n = ent["partitions"]
        per = (t.num_rows + n - 1) // n if n else t.num_rows
        return t.slice(partition * per, per)

    def prefetch(self, url: str, location: str,
                 rng: Optional[Tuple[int, int]] = None) -> int:
        """Read an object, or a byte range of it, through its store (and so
        into the byte cache) ahead of a query -> bytes read."""
        store = self.stores[url]
        if rng is None:
            data = store.get(location)
        else:
            data = store.get_range(location, rng[0], rng[1] - rng[0])
        return len(data)

    def metrics(self, handle: str) -> rpc.ExecutionMetricsResponse:
        """The plan's pushdown time beside the cache's memory; an empty
        handle names no plan and reads zero."""
        ent = self._plan(handle) if handle else None
        st = self.cache.stats()
        return rpc.ExecutionMetricsResponse(
            pushdown_eval_time=ent["eval_ms"] if ent else 0,
            cache_memory_usage=st["memory_used"],
            liquid_cache_usage=st["memory_used"])

    def reset(self) -> None:
        with self._lock:
            self.plans.clear()
        with self._engine:
            self.cache.reset()


class _FlightServer(fl.FlightServerBase):
    """The Arrow Flight front end (reference `:255-323`): DoAction carries
    the control messages as JSON bodies, DoGet a `FetchResults` ticket."""

    def __init__(self, location, inner):
        super().__init__(location)
        self.inner = inner

    def do_action(self, context, action):
        inner = self.inner
        body = action.body.to_pybytes() if action.body is not None else b""
        msg = json.loads(body or b"{}")
        t = action.type
        if t == "register_object_store":
            inner.register_object_store(msg["url"], msg.get("options", {}))
            out = {"ok": True}
        elif t == "register_plan":
            inner.register_plan(msg["plan"], msg["handle"],
                                msg.get("tables", {}),
                                msg.get("partitions", 1))
            out = {"ok": True, "partitions": msg.get("partitions", 1)}
        elif t == "prefetch":
            n = inner.prefetch(msg["url"], msg["location"],
                               tuple(msg["range"]) if msg.get("range")
                               else None)
            out = {"ok": True, "bytes": n}
        elif t == "execution_metrics":
            m = inner.metrics(msg.get("handle", ""))
            out = {"ok": True, "metrics": m.__dict__}
        elif t == "reset":
            inner.reset()
            out = {"ok": True}
        elif t == "stats":
            out = {"ok": True, "stats": inner.cache.stats()}
        else:
            raise fl.FlightServerError(f"unknown action {t!r}")
        yield fl.Result(json.dumps(out).encode())

    def do_get(self, context, ticket):
        msg = rpc.FetchResults(**json.loads(ticket.ticket))
        # continue the client's trace: the first piece executes under it
        with TRACER.remote_span("server.fetch", msg.traceparent,
                                handle=msg.handle, partition=msg.partition):
            gen = self.inner.execute_partition_stream(msg.handle,
                                                      msg.partition)
            first = next(gen)

        def batches():
            # later row groups execute as the client drains the stream
            yield from first.to_batches()
            for t in gen:
                yield from t.to_batches()

        return fl.GeneratorStream(first.schema, batches())


def _stop_within(what: str, stop, thread, timeout: float) -> None:
    """Run `stop()` and join the serving `thread`, both within `timeout`
    seconds; raise when either outlasts it."""
    deadline = time.monotonic() + timeout
    stopper = threading.Thread(target=stop, daemon=True)
    stopper.start()
    stopper.join(timeout)
    if thread is not None:
        thread.join(max(0.0, deadline - time.monotonic()))
    if stopper.is_alive() or (thread is not None and thread.is_alive()):
        raise RuntimeError(f"{what} did not stop within {timeout} s")


class LiquidCacheService:
    """The Flight service over a `LiquidCacheServiceInner` (reference
    `:326-343`); `start()` serves on a daemon thread, `stop()` ends it
    within `STOP_TIMEOUT_S` or raises."""

    def __init__(self, cache, host: str = "127.0.0.1", port: int = 0,
                 byte_cache_dir: Optional[str] = None):
        self.inner = LiquidCacheServiceInner(cache, byte_cache_dir)
        self._srv = _FlightServer(f"grpc://{host}:{port}", self.inner)
        self.addr = (host, self._srv.port)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._srv.serve, daemon=True)
        self._thread.start()
        return self.addr

    def stop(self, timeout: float = STOP_TIMEOUT_S) -> None:
        _stop_within("the Flight server", self._srv.shutdown, self._thread,
                     timeout)
