"""The port's schedule explorer (`utils/shuttle.py`) against the JAX
package's, on the CPU.

- A workload built before the scheduler is installed (the reference's
  idiom, plain locks) gives, seed for seed, the reference scheduler's
  trace and output: both draw from `random.Random(seed)` at the same
  points.
- The reference's five invariants (`tests/test_shuttle.py`) over the
  port's budget, cache and policy (the workloads of `bench/schedules.py`,
  which phase 6k of `chip_smoke.py` runs on the card): the same seed
  gives the same trace and state, replay reproduces a schedule (the
  cache's too, entries included), concurrent reserve / release never
  oversubscribes, concurrent inserts under pressure keep every entry
  readable and memory within the cap, an advice batch names no entry
  twice.
- `check` / `replay` build the workload with the scheduler installed, so
  its locks are the scheduler's: lock operations alone interleave tasks,
  which the reference's `check` never does (its locks are built before
  its scheduler is installed).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from liquid_tpu.utils import shuttle as jshuttle  # noqa: E402
from liquid_tpu.utils import sync as jsync  # noqa: E402
from liquid_tpu_torch.bench import schedules  # noqa: E402
from liquid_tpu_torch.utils import shuttle, sync  # noqa: E402


def _tagged(lock_factory, tags, rounds):
    """Tasks appending their tag `rounds` times under one lock -> (tasks,
    the list they append to)."""
    out = []
    lk = lock_factory()

    def w(tag):
        def go():
            for _ in range(rounds):
                with lk:
                    out.append(tag)
        return go
    return [w(t) for t in tags], out


@pytest.mark.parametrize("seed", [0, 7, 42, 43])
def test_plain_lock_workload_matches_reference(seed):
    fns, out = _tagged(sync.Lock, "abc", 5)
    trace = shuttle.Scheduler(seed=seed).run(fns)
    jfns, jout = _tagged(jsync.Lock, "abc", 5)
    jtrace = jshuttle.Scheduler(seed=seed).run(jfns)
    assert trace == jtrace
    assert out == jout


def test_scheduler_is_deterministic():
    """Same seed => the same schedule and the same observable state."""
    def make():
        fns, make.out = _tagged(sync.Lock, "abc", 5)
        return fns

    traces, orders = [], []
    for _ in range(2):
        s = shuttle.Scheduler(seed=42)
        s.run_workload(make)
        traces.append(tuple(s.trace))
        orders.append(tuple(make.out))
    assert traces[0] == traces[1]
    assert orders[0] == orders[1]
    s2 = shuttle.Scheduler(seed=43)
    s2.run_workload(make)
    assert tuple(s2.trace) != traces[0] or tuple(make.out) != orders[0]


def test_replay_reproduces_schedule():
    def make():
        fns, make.acc = _tagged(sync.Lock, [0, 1], 3)
        return fns

    s = shuttle.Scheduler(seed=7)
    s.run_workload(make)
    first, trace = list(make.acc), list(s.trace)
    assert shuttle.replay(make, trace) == trace
    assert make.acc == first


def test_lock_operations_interleave_tasks():
    """Under `check`, a workload whose only scheduling points are its
    locks' operations interleaves its tasks for some seed; the plain locks
    of the reference's idiom never switch a task out mid-way."""
    def make():
        fns, out = _tagged(sync.Lock, "ab", 4)
        make.outs.append(out)
        return fns
    make.outs = []
    shuttle.check(make, iterations=20)
    orders = {"".join(o) for o in make.outs}
    assert orders - {"aaaabbbb", "bbbbaaaa"}, orders
    ref = set()
    for seed in range(20):
        fns, out = _tagged(jsync.Lock, "ab", 4)
        jshuttle.Scheduler(seed=seed).run(fns)
        ref.add("".join(out))
    assert ref <= {"aaaabbbb", "bbbbaaaa"}, ref


def test_lock_outside_a_task_is_taken_directly():
    s = shuttle.Scheduler(seed=0)
    sync.install(s)
    try:
        lk = sync.RLock()
        cv = sync.Condition()
    finally:
        sync.uninstall()
    with lk:
        with lk:
            assert lk.locked()
    assert not lk.locked()
    with cv:
        pass
    assert sync.current() is None
    assert type(sync.Lock()).__module__ != shuttle.__name__


def test_condition_hand_off():
    """A waiter wakes on notify_all under every explored schedule."""
    def make():
        cv = sync.Condition()
        state = {"ready": False, "seen": None}

        def waiter():
            with cv:
                while not state["ready"]:
                    cv.wait()
                state["seen"] = True

        def setter():
            with cv:
                state["ready"] = True
                cv.notify_all()

        make.state = state
        return [waiter, setter]

    for seed in range(10):
        shuttle.Scheduler(seed=seed).run_workload(make)
        assert make.state["seen"] is True


def test_budget_invariant_under_schedules():
    """Concurrent reserve / release never oversubscribes and nets to zero
    (reference `tests/test_shuttle.py:70-99`), over 60 schedules."""
    make = schedules.budget_workload()
    shuttle.check(make, iterations=schedules.ITERATIONS["budget"])
    assert schedules.ITERATIONS["budget"] == 60
    assert make.budget.memory_used == 0


def test_cache_concurrent_inserts_under_schedules(tmp_path):
    """Concurrent inserts under memory pressure: every entry readable
    afterwards, memory within the cap (reference `:102-129`)."""
    make = schedules.insert_workload("cpu", str(tmp_path))
    shuttle.check(make, iterations=schedules.ITERATIONS["insert"])
    assert schedules.ITERATIONS["insert"] == 12
    assert make.cache.device.type == "cpu"
    schedules.check_inserts(make.cache)


def test_cache_insert_replay(tmp_path):
    """A recorded schedule of the insert workload replays to the same
    trace and the same entries in the same states."""
    make = schedules.insert_workload("cpu", str(tmp_path))
    s = shuttle.Scheduler(seed=3)
    trace = s.run_workload(make)
    states = schedules.check_inserts(make.cache)
    assert shuttle.replay(make, trace) == trace
    assert schedules.check_inserts(make.cache) == states


def test_eviction_advice_unique_per_pass():
    """find_memory_victims never names an entry twice in one batch
    (reference `:132-156`)."""
    shuttle.check(schedules.advice_workload(),
                  iterations=schedules.ITERATIONS["advice"])
    assert schedules.ITERATIONS["advice"] == 40


def test_violation_reports_seed_and_replays():
    """A broken invariant fails, naming its seed and the schedule."""
    def make():
        state = {"n": 0}

        def bump():
            v = state["n"]
            sync.yield_now()
            state["n"] = v + 1

        def check_done():
            assert state["n"] in (0, 2), "torn update"
        return [bump, bump, check_done]

    with pytest.raises(AssertionError, match="schedule violation at seed"):
        shuttle.check(make, iterations=50)
