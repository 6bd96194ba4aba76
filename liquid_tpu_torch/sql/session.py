"""Session API: the user-facing entry point (port of
`liquid_tpu/sql/session.py`).

    ctx, cache = LiquidCacheLocalBuilder().build()        # runs on CUDA
    ctx.register_parquet("hits", "hits.parquet")
    ctx.sql("SELECT COUNT(*) FROM hits WHERE x <> 0").to_arrow()

`with_device("cpu")` runs on the CPU; it is never chosen silently -- with
no card and no explicit device, `build()` raises.  The reference's disk
and squeeze options belong to cache tiers that are not ported yet and
raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Tuple

import pyarrow as pa

from liquid_tpu_torch.cache.core import LiquidCache, LiquidCacheBuilder
from liquid_tpu_torch.io.parquet import ParquetTable
from liquid_tpu_torch.sql.exec import QueryExecutor


class DataFrame:
    def __init__(self, table: pa.Table):
        self._t = table

    def to_arrow(self) -> pa.Table:
        return self._t

    def to_pandas(self):
        return self._t.to_pandas()

    def collect(self) -> pa.Table:
        return self._t

    def show(self, n: int = 20) -> None:
        print(self._t.slice(0, n))

    def __repr__(self):
        return repr(self._t)


class SessionContext:
    def __init__(self, cache: LiquidCache):
        self.cache = cache
        self._tables: Dict[str, ParquetTable] = {}
        self._next_file_id = 0
        self._exec = QueryExecutor(self._tables, cache.device)

    @property
    def device(self):
        return self.cache.device

    def register_parquet(self, name: str, path: str) -> None:
        old = self._tables.get(name)
        if old is not None:
            # the replaced table's prep reservations and cache entries
            # would otherwise outlive it
            from liquid_tpu_torch.sql.fused_agg import release_prep_cache
            release_prep_cache(old)
            self.cache.remove_file(old.file_id)
        fid = self._next_file_id
        self._next_file_id += 1
        self._tables[name] = ParquetTable(name, path, self.cache, fid)

    def table_names(self):
        return list(self._tables)

    def sql(self, query: str) -> DataFrame:
        return DataFrame(self._exec.execute_sql(query))


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what}: the squeezed and disk cache tiers are not ported yet")


class LiquidCacheLocalBuilder:
    """Fluent builder mirroring the reference's local-mode API, plus the
    device to run on (default CUDA)."""

    def __init__(self, device=None):
        self._b = LiquidCacheBuilder()
        if device is not None:
            self._b.with_device(device)

    def with_device(self, device) -> "LiquidCacheLocalBuilder":
        self._b.with_device(device)
        return self

    def with_max_memory_bytes(self, n: int) -> "LiquidCacheLocalBuilder":
        self._b.with_max_memory_bytes(n)
        return self

    def with_cache_policy(self, p) -> "LiquidCacheLocalBuilder":
        self._b.with_cache_policy(p)
        return self

    def with_transcode_on_insert(self, b: bool) -> "LiquidCacheLocalBuilder":
        self._b.with_transcode_on_insert(b)
        return self

    def with_max_disk_bytes(self, n: int):
        _not_ported("with_max_disk_bytes")

    def with_cache_dir(self, d: str):
        _not_ported("with_cache_dir")

    def with_squeeze_policy(self, p):
        _not_ported("with_squeeze_policy")

    def build(self) -> Tuple[SessionContext, LiquidCache]:
        cache = self._b.build()
        return SessionContext(cache), cache
