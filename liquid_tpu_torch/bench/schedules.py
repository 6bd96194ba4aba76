"""The reference's schedule-exploration workloads over the port's cache
runtime (`tests/test_shuttle.py:70-156` of the reference), for
`utils/shuttle.check` / `replay`.

Each function returns a `make_workload()` callable: a fresh set of tasks
per schedule, with the state they share left on the callable (`.budget`,
`.cache`, `.policy`) for the caller to check after a run.  A task that
sees an invariant broken raises AssertionError, which `shuttle.check`
turns into a failure naming the seed and the schedule.

- `budget_workload()`: three tasks reserve and release random byte
  counts under a 1,000-byte budget; the budget is never oversubscribed
  and nets to zero (reference budget accounting, `budget.rs:133-201`).
- `insert_workload(device, tmp_dir)`: two tasks insert three blocks
  each into a 40,000-byte cache on `device` with a disk tier; every
  entry stays readable and memory stays within the cap (`core.rs:1118-1178`).
- `advice_workload()`: two tasks insert into a `LiquidPolicy` while a
  third takes eviction advice; no advice batch names an entry twice
  (`policies/cache/mod.rs:41-95`).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import pyarrow as pa

#: the reference's iteration counts for the three workloads
ITERATIONS = {"budget": 60, "insert": 12, "advice": 40}

INSERT_CAP = 40_000


def budget_workload(cap: int = 1000):
    from liquid_tpu_torch.cache.budget import BudgetAccounting
    from liquid_tpu_torch.utils import sync

    def make():
        b = BudgetAccounting(cap)

        def worker(seed):
            def go():
                rng = np.random.default_rng(seed)
                held = []
                for _ in range(6):
                    n = int(rng.integers(1, 400))
                    if b.try_reserve_memory(n):
                        held.append(n)
                        used = b.memory_used
                        assert used <= cap, f"oversubscribed: {used}"
                    sync.yield_now()
                for n in held:
                    b.release_memory(n)
            return go
        make.budget = b
        return [worker(i) for i in range(3)]
    return make


def insert_arrays():
    """The six int64 blocks of 2,048 rows the insert tasks take turns at."""
    return [pa.array(np.random.default_rng(i).integers(
        0, 1000, 2048).astype(np.int64)) for i in range(6)]


def insert_keys():
    """(entry id, index into `insert_arrays()`) of every insert."""
    return [(base * 16 + i, (base + i) % 6) for base in (0, 1)
            for i in range(3)]


def insert_workload(device, tmp_dir=None):
    from liquid_tpu_torch.cache import LiquidCacheBuilder
    arrs = insert_arrays()

    def make():
        d = tempfile.mkdtemp(dir=tmp_dir)
        cache = (LiquidCacheBuilder()
                 .with_max_memory_bytes(INSERT_CAP)
                 .with_disk_path(os.path.join(d, "s.bin"))
                 .with_device(device)
                 .build())

        def worker(base):
            def go():
                for i in range(3):
                    cache.insert(base * 16 + i, arrs[(base + i) % len(arrs)])
                    assert cache.stats()["memory_used"] <= INSERT_CAP
            return go
        make.cache = cache
        return [worker(0), worker(1)]
    return make


def check_inserts(cache) -> dict:
    """Every inserted entry reads back whole and memory is within the
    cap -> {entry id: state}."""
    arrs = insert_arrays()
    assert cache.stats()["memory_used"] <= INSERT_CAP, cache.stats()
    states = {}
    for eid, ai in insert_keys():
        got = cache.get(eid)
        assert got is not None, eid
        assert got.to_pylist() == arrs[ai].to_pylist(), eid
        states[eid] = cache.entry_state(eid)
    return states


def advice_workload():
    from liquid_tpu_torch.cache.policies import LiquidPolicy

    def make():
        p = LiquidPolicy()

        def inserter(base):
            def go():
                for i in range(8):
                    p.notify_inserted(base + i, "arrow")
            return go

        def advisor():
            def go():
                for _ in range(4):
                    batch = p.find_memory_victims(4)
                    assert len(batch) == len(set(batch)), batch
                    for v in batch:
                        p.notify_removed(v)
            return go
        make.policy = p
        return [inserter(0), inserter(100), advisor()]
    return make
