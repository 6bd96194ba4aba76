"""One closed-loop client, like an analyst or a dashboard waiting for each
answer: the workload's queries in their listed order, round robin, with
fixed literals.  The window ends with the pass in which its time runs
out, so every query of the mix weighs the same in it.

A workload names its traffic by the file name here (`"traffic"`); each
such file defines `drive(answer, workload, deadline_ns, record)`, which
calls `answer(query)` until the deadline and `record(query, start_ns,
end_ns, out, error)` for every request, on the host's `perf_counter_ns`
clock.
"""
from __future__ import annotations

import time


def drive(answer, workload: dict, deadline_ns: int, record) -> None:
    queries = workload["queries"]
    i, end = 0, time.perf_counter_ns()
    while end < deadline_ns or i % len(queries):
        q = queries[i % len(queries)]
        i += 1
        start = time.perf_counter_ns()
        out, error = None, None
        try:
            out = answer(q)
        except Exception as e:  # an answer that never comes fails
            error = e
        end = time.perf_counter_ns()
        record(q, start, end, out, error)
