"""exec.grouping_passes (passes per statement): the grouped passes that
one GROUP BY ROLLUP / CUBE / GROUPING SETS makes in the traced window --
the `exec.grouping_set` spans (one per set, each a whole grouped query:
its joins, scans and any UNION below it) over the `sql.grouping_sets`
spans.  A program that derived the coarser sets from the finest pass
would read 1.  None for a program that records no `sql.grouping_sets`
span."""
from cachebench.spans import layer_spans_recorded


def read(run):
    if not layer_spans_recorded(run):
        return None
    stmts = sum(s.name == "sql.grouping_sets" for s in run.spans)
    if not stmts:
        return None
    return sum(s.name == "exec.grouping_set" for s in run.spans) / stmts
