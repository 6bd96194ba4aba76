"""Benchmark sessions per mode, and the per-process disk IO counter (port
of `make_session` and `DiskIoGuard` in `liquid_tpu/bench/runner.py`).

The modes are the reference's:
- `liquid` caches transcoded blocks under the default squeeze policy
  (`TranscodeSqueezeEvict`) and answers through the fused device routes;
- `arrow` keeps arrow blocks (no transcode on insert) and evicts them to
  disk as they are (`Evict`), so it answers through the classic path;
- `liquid-no-squeeze` transcodes but skips the squeezed stage
  (`TranscodeEvict`).
"""
from __future__ import annotations

from typing import Dict, Optional

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
