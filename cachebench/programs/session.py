"""The program under test by default: a session of `liquid_tpu_torch` in
the measuring process, driven through its public entry point:
`LiquidCacheLocalBuilder(...).build()`, `ctx.register_parquet`, then per
query `ctx.sql(sql).to_arrow()` and `torch.cuda.synchronize()`.

A workload names its program by the file name here (`"program"`); each
such file defines `Program(torch, device,
workload, paths, sqls)` with `transcode(columns)`, `answer(query)` and
`close()`.
"""
from __future__ import annotations

import gc
import os
from typing import Dict, List

import pyarrow as pa

from cachebench.spec import HERE

WORK_DIR = os.path.join(HERE, "_work")


class Program:
    """A session of `liquid_tpu_torch` over the cell's tables."""

    def __init__(self, torch, device: str, workload: dict,
                 paths: Dict[str, str], sqls: Dict[str, str]):
        from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
        self.torch, self.device, self.sqls = torch, device, sqls
        cache_dir = os.path.join(WORK_DIR, "cache")
        os.makedirs(cache_dir, exist_ok=True)
        self.ctx, self.cache = (
            LiquidCacheLocalBuilder(device=device)
            .with_max_memory_bytes(workload["max_memory_bytes"])
            .with_cache_dir(cache_dir).build())
        for name, path in paths.items():
            self.ctx.register_parquet(name, path)

    def transcode(self, columns: Dict[str, List[str]]) -> None:
        """Offer every row group of the named columns to the cache.  The
        session has no public call that caches a column without answering
        a query, and a query over every column would add its own work to
        the transcode's time, so this reads the registered tables."""
        for name, cols in columns.items():
            table = self.ctx._tables[name]
            for rg in range(table.num_row_groups):
                for c in cols:
                    table.ensure_cached(rg, c)

    def answer(self, query: str) -> pa.Table:
        out = self.ctx.sql(self.sqls[query]).to_arrow()
        if self.device != "cpu":
            self.torch.cuda.synchronize()
        return out

    def close(self) -> None:
        self.ctx = self.cache = None
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()
