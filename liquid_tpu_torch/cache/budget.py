"""Memory and disk byte budgets (port of `liquid_tpu/cache/budget.py`).

`try_reserve_*` fails without side effects when over budget.  The disk
budget is unbounded unless a maximum is given.  `try_update_memory_usage`
swaps a reservation when the new size fits; `force_update_memory_usage`
swaps it unconditionally (the squeeze pipeline: the replacement loop keeps
squeezing until usage drops).
"""
from __future__ import annotations

from typing import Optional

from liquid_tpu_torch.utils import sync as _sync


class BudgetExceeded(Exception):
    pass


class BudgetAccounting:
    def __init__(self, max_memory_bytes: int,
                 max_disk_bytes: Optional[int] = None):
        self._lock = _sync.Lock()
        self.max_memory_bytes = max_memory_bytes
        self.max_disk_bytes = max_disk_bytes  # None: unbounded
        self._memory_used = 0
        self._disk_used = 0

    @property
    def memory_used(self) -> int:
        return self._memory_used

    @property
    def disk_used(self) -> int:
        return self._disk_used

    def try_reserve_memory(self, nbytes: int) -> bool:
        with self._lock:
            if self._memory_used + nbytes > self.max_memory_bytes:
                return False
            self._memory_used += nbytes
            return True

    def release_memory(self, nbytes: int) -> None:
        with self._lock:
            if nbytes > self._memory_used:
                raise RuntimeError("memory accounting underflow")
            self._memory_used -= nbytes

    def try_update_memory_usage(self, old: int, new: int) -> bool:
        """Swap a reservation from `old` to `new` bytes if it fits."""
        with self._lock:
            delta = new - old
            if delta > 0 and self._memory_used + delta > self.max_memory_bytes:
                return False
            if self._memory_used + delta < 0:
                raise RuntimeError("memory accounting underflow")
            self._memory_used += delta
            return True

    def force_update_memory_usage(self, old: int, new: int) -> None:
        """Swap a reservation unconditionally."""
        with self._lock:
            if self._memory_used + new - old < 0:
                raise RuntimeError("memory accounting underflow")
            self._memory_used += new - old

    def try_reserve_disk(self, nbytes: int) -> bool:
        with self._lock:
            if (self.max_disk_bytes is not None
                    and self._disk_used + nbytes > self.max_disk_bytes):
                return False
            self._disk_used += nbytes
            return True

    def release_disk(self, nbytes: int) -> None:
        with self._lock:
            if nbytes > self._disk_used:
                raise RuntimeError("disk accounting underflow")
            self._disk_used -= nbytes
