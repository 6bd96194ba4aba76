"""Memory byte budget (port of `liquid_tpu/cache/budget.py`, memory half).

`try_reserve_memory` fails without side effects when over budget.  The
disk budget belongs to the disk tiers, which the port does not have yet.
"""
from __future__ import annotations

from liquid_tpu_torch.utils import sync as _sync


class BudgetAccounting:
    def __init__(self, max_memory_bytes: int):
        self._lock = _sync.Lock()
        self.max_memory_bytes = max_memory_bytes
        self._memory_used = 0

    @property
    def memory_used(self) -> int:
        return self._memory_used

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
