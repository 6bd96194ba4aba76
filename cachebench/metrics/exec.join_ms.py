"""exec.join_ms (ms per query): the classic path's pairwise join folds --
the outermost `exec.join` spans (the device sort-merge with its key
encoding and gathers, or the host join it hands back to; the sides' reads
stay outside) less the `wait.*` spans they hold -- over the queries
completed.  None for a program that records no `exec.join` span."""
from cachebench.spans import per_query_ms


def read(run):
    if not any(s.name == "exec.join" for s in run.spans):
        return None
    return per_query_ms(run, lambda s: s.name == "exec.join")
