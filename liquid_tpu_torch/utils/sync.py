"""Lock factories and scheduling points for the cache runtime (port of
`liquid_tpu/utils/sync.py`).

The cache, its budget, policies, store and observer build every lock
through this module.  By default they are plain `threading` primitives
with no overhead.  While a deterministic scheduler is installed
(`utils/shuttle.py`, `Scheduler.run`), the factories hand out
scheduler-controlled locks and conditions instead, and `yield_now` is a
scheduling point (the reference's `yield_now_if_shuttle`), so every
interleaving decision is made by a seeded PRNG and can be replayed.
"""
from __future__ import annotations

import threading

#: the installed deterministic scheduler, or None for plain threading
_SCHED = None


def install(sched) -> None:
    global _SCHED
    _SCHED = sched


def uninstall() -> None:
    global _SCHED
    _SCHED = None


def current():
    return _SCHED


def Lock():
    if _SCHED is not None:
        return _SCHED.make_lock(reentrant=False)
    return threading.Lock()


def RLock():
    if _SCHED is not None:
        return _SCHED.make_lock(reentrant=True)
    return threading.RLock()


def Condition(lock=None):
    if _SCHED is not None:
        return _SCHED.make_condition(lock)
    return threading.Condition(lock)


def yield_now() -> None:
    """A scheduling point under a deterministic scheduler; a no-op
    otherwise."""
    if _SCHED is not None:
        _SCHED.yield_point("yield_now")
