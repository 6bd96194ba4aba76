"""Benchmark tracepoints (host copy of `liquid_tpu/bench/tracepoints.py`).

Reference behavior: the USDT probe `liquid_benchmark:iteration_start`
that bpftrace attaches to (liquid-cache `benchmark/src/tracepoints.rs`).
Python has no USDT probe of its own: the marker is a line appended to
the file that `LIQUID_TPU_TRACEPOINT_FILE` names, and a call to every
in-process subscriber.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List

_subscribers: List[Callable] = []
TRACE_PATH = os.environ.get("LIQUID_TPU_TRACEPOINT_FILE", "")


def subscribe(fn: Callable) -> None:
    _subscribers.append(fn)


def iteration_start(benchmark: str, query_index: int) -> None:
    """The marker fired at the start of each query's iterations."""
    for fn in _subscribers:
        fn(benchmark, query_index)
    if TRACE_PATH:
        with open(TRACE_PATH, "a") as f:
            f.write(f"{time.time_ns()} iteration_start "
                    f"{benchmark} {query_index}\n")
