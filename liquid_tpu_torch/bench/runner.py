"""Benchmark sessions per mode (port of `make_session` in
`liquid_tpu/bench/runner.py`).

The modes are the reference's: `liquid` caches transcoded blocks and
answers through the fused device path; `arrow` keeps arrow blocks and
answers on the host's classic path; `liquid-no-squeeze` swaps the squeeze
policy.  Only `liquid` runs in the port: the classic path and the
squeezed tiers are not ported yet, so the other two raise
NotImplementedError.  The reference's cache directory belongs to the disk
tier and is not taken.
"""
from __future__ import annotations

#: the reference's benchmark modes
MODES = ("arrow", "liquid", "liquid-no-squeeze")


def make_session(mode: str, max_memory_bytes: int, device=None):
    """A local session for one benchmark mode -> (ctx, cache)."""
    from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
    if mode == "arrow":
        raise NotImplementedError(
            "benchmark mode 'arrow' needs the classic (host) path, which is "
            "not ported yet")
    if mode == "liquid-no-squeeze":
        raise NotImplementedError(
            "benchmark mode 'liquid-no-squeeze' needs the squeeze policies, "
            "which are not ported yet")
    if mode != "liquid":
        raise ValueError(f"unknown mode {mode!r}")
    return (LiquidCacheLocalBuilder(device=device)
            .with_max_memory_bytes(max_memory_bytes).build())
