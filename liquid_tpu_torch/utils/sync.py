"""Lock factories for the cache runtime (port of `liquid_tpu/utils/sync.py`).

The reference routes every lock through this module so a deterministic
scheduler can take them over in its concurrency tests; the port has no
such scheduler yet, so these are plain `threading` primitives.  Keeping
the seam means the cache code reads the same in both packages.
"""
from __future__ import annotations

import threading


def Lock():
    return threading.Lock()


def RLock():
    return threading.RLock()
