"""sql.host_self_ms (ms per query): the SQL layer's own host time in the
traced window -- each `sql.execute` span's length less the union of its
direct `sql.*` and `cache.*` children and of the host's waits for the card
(the blocking CUDA runtime calls the profiler records) -- over the
queries completed.  Card time that the SQL layer waits on is the device's,
so a kernel or decode that gets faster does not move it."""
from bisect import bisect_left
from collections import defaultdict

from cachebench.trace import union


def read(run):
    execs = [s for s in run.spans if s.name == "sql.execute"]
    if not execs or not run.completed:
        return None
    kids = defaultdict(list)
    for s in run.spans:
        if s.parent_id and s.name.startswith(("sql.", "cache.")):
            kids[s.parent_id].append((s.start, s.end))
    waits = union(run.host_waits)
    ends = [e for _b, e in waits]
    self_ns = 0
    for s in execs:
        inside, i = [], bisect_left(ends, s.start + 1)
        while i < len(waits) and waits[i][0] < s.end:
            b, e = waits[i]
            inside.append((max(b, s.start), min(e, s.end)))
            i += 1
        self_ns += (s.end - s.start) - sum(
            e - b for b, e in union(kids[s.span_id] + inside))
    return self_ns / 1e6 / run.completed
