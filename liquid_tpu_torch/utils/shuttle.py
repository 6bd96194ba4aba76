"""Deterministic schedule exploration for the host cache runtime (port of
`liquid_tpu/utils/shuttle.py`, reference `:92-272`).

A multi-threaded workload runs under a scheduler that owns every
interleaving decision: tasks run on real threads but strictly one at a
time, under a token the scheduler hands out.  Every lock acquire and
release made through `utils/sync.py`, every condition wait / notify and
every explicit `sync.yield_now()` is a scheduling point where a seeded
PRNG picks the next runnable task.  The chosen task sequence is recorded,
so a failing schedule replays exactly.

    from liquid_tpu_torch.utils import shuttle
    shuttle.check(make_workload, iterations=200)   # explore seeds
    shuttle.replay(make_workload, schedule)        # reproduce one

`check` and `replay` build the workload with the scheduler installed, so
the locks that `make_workload` creates (a cache's, its budget's, its
policy's) are the scheduler's and each of their operations is a
scheduling point.  The reference builds the workload before installing
its scheduler, which leaves those locks plain `threading` ones and only
`yield_now` calls to decide interleavings.  The trace records every
decision, a task kept running included; the reference records only
switches, so its replay of a schedule with such a decision reads the
wrong entries.  A lock operation outside any task (building the
workload, reading the state after a run) takes the lock directly.
"""
from __future__ import annotations

import random
import threading
from typing import Callable, List, Optional, Sequence

from liquid_tpu_torch.utils import sync as _sync

#: the owner id of a lock taken outside any task
_OUTSIDE = -1


class _Task:
    def __init__(self, tid: int, fn: Callable[[], None]):
        self.tid = tid
        self.fn = fn
        self.gate = threading.Event()
        self.done = False
        self.blocked_on = None      # a _DLock, "cond", or None
        self.exc: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None


class _DLock:
    """Scheduler-controlled (r)lock: acquire blocks the task, not the OS
    thread, until the scheduler grants the lock."""

    def __init__(self, sched: "Scheduler", reentrant: bool):
        self.sched = sched
        self.reentrant = reentrant
        self.owner: Optional[int] = None
        self.count = 0

    def acquire(self, blocking: bool = True):
        return self.sched.lock_acquire(self, blocking)

    def release(self):
        self.sched.lock_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self.owner is not None


class _DCondition:
    """Condition over a scheduler lock (wait / notify / notify_all)."""

    def __init__(self, sched: "Scheduler", lock: Optional[_DLock]):
        self.sched = sched
        self.lock = lock or _DLock(sched, reentrant=True)
        self.waiters: List[int] = []

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()

    def wait(self, timeout=None):
        self.sched.cond_wait(self)

    def notify_all(self):
        self.sched.cond_notify(self, all=True)

    def notify(self, n: int = 1):
        self.sched.cond_notify(self, all=False)


class Scheduler:
    def __init__(self, seed: Optional[int] = None,
                 schedule: Optional[Sequence[int]] = None):
        self.rng = random.Random(seed)
        self.forced = list(schedule) if schedule is not None else None
        self.trace: List[int] = []     # chosen task per step (replayable)
        self.tasks: List[_Task] = []
        self.current: Optional[_Task] = None
        self._cv = threading.Condition()

    # -- factories (utils.sync hooks) ---------------------------------------

    def make_lock(self, reentrant: bool) -> _DLock:
        return _DLock(self, reentrant)

    def make_condition(self, lock) -> _DCondition:
        return _DCondition(self, lock if isinstance(lock, _DLock) else None)

    # -- task switching ------------------------------------------------------

    def _runnable(self) -> List[_Task]:
        out = []
        for t in self.tasks:
            if t.done or t.thread is None or t.blocked_on == "cond":
                continue
            lk = t.blocked_on
            if lk is not None and lk.owner is not None and lk.owner != t.tid:
                continue
            out.append(t)
        return out

    def _pick_next(self) -> Optional[_Task]:
        runnable = self._runnable()
        if not runnable:
            return None
        if self.forced:
            want = self.forced.pop(0)
            for t in runnable:
                if t.tid == want:
                    return t
            # the forced task is not runnable (a divergent replay): fall
            # through to the PRNG
        return self.rng.choice(runnable)

    def _switch_to(self, task: Optional[_Task]) -> None:
        """Called with self._cv held."""
        self.current = task
        if task is not None:
            self.trace.append(task.tid)
            task.gate.set()

    def _park(self, me: _Task) -> None:
        """Hand the token to the next runnable task and wait for it back."""
        with self._cv:
            me.gate.clear()
            self._switch_to(self._pick_next())
            self._cv.notify_all()
        me.gate.wait()

    def yield_point(self, why: str = "") -> None:
        """The running task offers a scheduling decision (none outside a
        task)."""
        me = self.current
        if me is None:
            return
        with self._cv:
            nxt = self._pick_next()
            if nxt is me:  # keep running; recorded, so a replay stays too
                self.trace.append(me.tid)
                return
            me.gate.clear()
            self._switch_to(nxt)
            self._cv.notify_all()
        me.gate.wait()

    # -- lock operations -----------------------------------------------------

    def lock_acquire(self, lk: _DLock, blocking: bool) -> bool:
        me = self.current
        tid = _OUTSIDE if me is None else me.tid
        self.yield_point("pre-acquire")
        while True:
            if lk.owner is None or (lk.reentrant and lk.owner == tid):
                lk.owner = tid
                lk.count += 1
                return True
            if not blocking:
                return False
            if me is None:
                raise RuntimeError("a lock held by a task was taken "
                                   "outside any task")
            me.blocked_on = lk
            self._park(me)
            me.blocked_on = None

    def lock_release(self, lk: _DLock) -> None:
        me = self.current
        tid = _OUTSIDE if me is None else me.tid
        assert lk.owner == tid, "release of foreign lock"
        lk.count -= 1
        if lk.count == 0:
            lk.owner = None
        self.yield_point("post-release")

    def cond_wait(self, cond: _DCondition) -> None:
        me = self.current
        held = cond.lock.count
        cond.lock.count = 0
        cond.lock.owner = None
        cond.waiters.append(me.tid)
        me.blocked_on = "cond"
        self._park(me)
        # take the lock back with the count it had
        self.lock_acquire(cond.lock, True)
        cond.lock.count = held

    def cond_notify(self, cond: _DCondition, all: bool) -> None:
        woken = cond.waiters[:] if all else cond.waiters[:1]
        cond.waiters = [] if all else cond.waiters[1:]
        for tid in woken:
            self.tasks[tid].blocked_on = None
        self.yield_point("notify")

    # -- run -----------------------------------------------------------------

    def run(self, fns: Sequence[Callable[[], None]]) -> List[int]:
        """Run the tasks to completion under this scheduler -> the
        recorded schedule.  A task's exception is raised after every task
        has ended; a task that never ends raises with the schedule so
        far."""
        self.tasks = [_Task(i, fn) for i, fn in enumerate(fns)]

        def body(task: _Task):
            task.gate.wait()
            try:
                task.fn()
            except BaseException as ex:  # surfaced after join
                task.exc = ex
            finally:
                task.done = True
                with self._cv:
                    self._switch_to(self._pick_next())
                    self._cv.notify_all()

        _sync.install(self)
        try:
            for t in self.tasks:
                t.thread = threading.Thread(target=body, args=(t,),
                                            daemon=True)
                t.thread.start()
            with self._cv:
                self._switch_to(self._pick_next())
            for t in self.tasks:
                t.thread.join(timeout=60)
                if t.thread.is_alive():
                    raise RuntimeError(
                        f"deadlock: task {t.tid} never finished; "
                        f"schedule so far: {self.trace}")
            for t in self.tasks:
                if t.exc is not None:
                    raise t.exc
        finally:
            _sync.uninstall()
        return self.trace

    def run_workload(self, make_workload: Callable[[], Sequence[Callable]]
                     ) -> List[int]:
        """Build the workload with this scheduler installed (its locks are
        the scheduler's), then run it -> the recorded schedule."""
        _sync.install(self)
        try:
            fns = make_workload()
        finally:
            _sync.uninstall()
        return self.run(fns)


def check(make_workload: Callable[[], Sequence[Callable[[], None]]],
          iterations: int = 100, base_seed: int = 0) -> None:
    """Explore `iterations` seeded schedules of the workload; a failure
    raises with the seed and the schedule to replay it (reference
    `:250-266`)."""
    for i in range(iterations):
        seed = base_seed + i
        sched = Scheduler(seed=seed)
        try:
            sched.run_workload(make_workload)
        except BaseException as ex:
            raise AssertionError(
                f"schedule violation at seed {seed}: {ex}\n"
                f"replay with shuttle.replay(make_workload, "
                f"{sched.trace!r})") from ex


def replay(make_workload: Callable[[], Sequence[Callable[[], None]]],
           schedule: Sequence[int]) -> List[int]:
    """Run the workload again under a recorded schedule -> its trace."""
    return Scheduler(seed=0, schedule=schedule).run_workload(make_workload)
