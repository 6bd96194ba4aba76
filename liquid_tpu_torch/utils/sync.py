"""Lock factories and scheduling points for the cache runtime (port of
`liquid_tpu/utils/sync.py`).

The reference routes every lock and the replacement loop's scheduling
point through this module so a deterministic scheduler can take them over
in its concurrency tests; the port has no such scheduler yet, so these
are plain `threading` primitives and `yield_now` does nothing.  Keeping
the seam means the cache code reads the same in both packages.
"""
from __future__ import annotations

import threading


def Lock():
    return threading.Lock()


def RLock():
    return threading.RLock()


def yield_now() -> None:
    """A scheduling point (the reference's `yield_now_if_shuttle`); a
    no-op outside a deterministic run, and the port has none."""
