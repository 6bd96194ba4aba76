"""Benchmark sessions per mode, the per-process disk IO counter and the
in-process manifest runner (port of `liquid_tpu/bench/runner.py`).

`InProcessRunner` (reference `:73-168`; liquid-cache
`benchmark/src/inprocess_runner.rs:30-120`) runs a manifest's queries in
local mode, each for a number of iterations, with this process's CPU
time, peak RSS and disk IO around each one (`getrusage`, `/proc/self/io`),
and checks each answer against a stored parquet answer where the
manifest names a directory of them; `save_answers` writes those answers
from a run (reference `:171-180`).

The modes are the reference's:
- `liquid` caches transcoded blocks under the default squeeze policy
  (`TranscodeSqueezeEvict`) and answers through the fused device routes;
- `arrow` keeps arrow blocks (no transcode on insert) and evicts them to
  disk as they are (`Evict`), so it answers through the classic path;
- `liquid-no-squeeze` transcodes but skips the squeezed stage
  (`TranscodeEvict`).
"""
from __future__ import annotations

import json
import os
import resource
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import pyarrow as pa

from liquid_tpu_torch.bench.manifest import Manifest

#: the reference's benchmark modes
MODES = ("arrow", "liquid", "liquid-no-squeeze")


def make_session(mode: str, max_memory_bytes: int,
                 cache_dir: Optional[str] = None, device=None):
    """A local session for one benchmark mode -> (ctx, cache)."""
    from liquid_tpu_torch.cache.policies import Evict, TranscodeEvict
    from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
    b = LiquidCacheLocalBuilder(device=device).with_max_memory_bytes(
        max_memory_bytes)
    if cache_dir is not None:
        b = b.with_cache_dir(cache_dir)
    if mode == "arrow":
        b = b.with_transcode_on_insert(False).with_squeeze_policy(Evict())
    elif mode == "liquid-no-squeeze":
        b = b.with_squeeze_policy(TranscodeEvict())
    elif mode != "liquid":
        raise ValueError(f"unknown mode {mode!r}")
    return b.build()


class DiskIoGuard:
    """This process's disk IO over a `with` block, from /proc/self/io:
    `read_bytes` and `write_bytes` after exit (0 where the kernel keeps
    no such counters)."""

    def __enter__(self):
        self._start = self._read()
        return self

    def __exit__(self, *exc):
        end = self._read()
        self.read_bytes = end.get("read_bytes", 0) - self._start.get(
            "read_bytes", 0)
        self.write_bytes = end.get("write_bytes", 0) - self._start.get(
            "write_bytes", 0)

    @staticmethod
    def _read() -> Dict[str, int]:
        try:
            out = {}
            with open("/proc/self/io") as f:
                for line in f:
                    k, _, v = line.partition(":")
                    out[k.strip()] = int(v)
            return out
        except OSError:
            return {}


@dataclass
class QueryResult:
    query_index: int
    sql: str
    iterations: List[dict] = field(default_factory=list)
    verified: Optional[bool] = None

    @property
    def best_ms(self) -> float:
        return min(i["ms"] for i in self.iterations)


class InProcessRunner:
    """A manifest's queries on a local session of one mode, on `device`
    (CUDA when None)."""

    def __init__(self, manifest: Manifest, mode: str = "liquid",
                 max_memory_bytes: int = 1 << 30,
                 cache_dir: Optional[str] = None, iterations: int = 3,
                 device=None):
        self.manifest = manifest
        self.mode = mode
        self.iterations = iterations
        cache_dir = cache_dir or os.path.join(tempfile.gettempdir(),
                                              "liquid_tpu_torch_bench")
        os.makedirs(cache_dir, exist_ok=True)
        self.ctx, self.cache = make_session(mode, max_memory_bytes,
                                            cache_dir, device)
        for name, path in manifest.tables.items():
            self.ctx.register_parquet(name, path)

    def _run_one(self, sql) -> pa.Table:
        """One query, or a statement list (its last result with columns)."""
        if isinstance(sql, list):
            out = pa.table({})
            for stmt in sql:
                r = self.ctx.sql(stmt).to_arrow()
                if r.num_columns:
                    out = r
            return out
        return self.ctx.sql(sql).to_arrow()

    def run(self, verify: bool = True) -> dict:
        results: List[QueryResult] = []
        for qi, sql in enumerate(self.manifest.queries):
            qr = QueryResult(qi, sql if isinstance(sql, str) else ";".join(sql))
            out = None
            for _ in range(self.iterations):
                ru0 = resource.getrusage(resource.RUSAGE_SELF)
                with DiskIoGuard() as io:
                    t0 = time.perf_counter()
                    out = self._run_one(sql)
                    ms = (time.perf_counter() - t0) * 1000
                ru1 = resource.getrusage(resource.RUSAGE_SELF)
                qr.iterations.append({
                    "ms": ms,
                    "rows": out.num_rows,
                    "user_cpu_s": ru1.ru_utime - ru0.ru_utime,
                    "sys_cpu_s": ru1.ru_stime - ru0.ru_stime,
                    "max_rss_kb": ru1.ru_maxrss,
                    "disk_read_bytes": io.read_bytes,
                    "disk_write_bytes": io.write_bytes,
                })
            if verify and self.manifest.answers is not None:
                qr.verified = self._verify(qi, out)
            results.append(qr)
        return {
            "manifest": self.manifest.name,
            "mode": self.mode,
            "cache_stats": self.cache.stats(),
            "queries": [{"query": r.query_index, "best_ms": r.best_ms,
                         "verified": r.verified,
                         "iterations": r.iterations} for r in results],
        }

    def _verify(self, qi: int, out: pa.Table) -> Optional[bool]:
        """The answer against the stored `q{qi}.parquet` (None when there
        is none): same shape, floats within rtol 1e-6 / atol 1e-9 (NaN
        equal to NaN), everything else equal."""
        import pyarrow.parquet as pq
        path = os.path.join(self.manifest.answers, f"q{qi}.parquet")
        if not os.path.exists(path):
            return None
        expect = pq.read_table(path)
        if out.num_rows != expect.num_rows \
                or out.num_columns != expect.num_columns:
            return False
        out = out.rename_columns(expect.column_names)
        for c in expect.column_names:
            a, b = out.column(c), expect.column(c)
            if pa.types.is_floating(b.type):
                av = a.cast(pa.float64()).to_numpy(zero_copy_only=False)
                bv = b.cast(pa.float64()).to_numpy(zero_copy_only=False)
                nan = np.isnan(av) & np.isnan(bv)
                if not (nan | np.isclose(av, bv, rtol=1e-6, atol=1e-9)).all():
                    return False
            elif a.cast(b.type) != b.combine_chunks() \
                    and a.to_pylist() != b.to_pylist():
                return False
        return True

    def write_results(self, out_path: str, results: dict) -> None:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2, default=str)


def save_answers(manifest: Manifest, out_dir: str, mode: str = "liquid",
                 **kw) -> None:
    """Write each query's answer from one run as `q{i}.parquet` (the
    reference ships such files in `benchmark/*/answers/`)."""
    import pyarrow.parquet as pq
    os.makedirs(out_dir, exist_ok=True)
    runner = InProcessRunner(manifest, mode=mode, iterations=1, **kw)
    for qi, sql in enumerate(manifest.queries):
        out = runner._run_one(sql)
        pq.write_table(out, os.path.join(out_dir, f"q{qi}.parquet"))
