"""fused.plan_miss_pct (%): the share of the fused routes' plan-cache
lookups in the traced window that missed and planned -- 100 x the
`fused.plan` spans over the `fused.lookup` spans (the fused aggregate's,
the fused distinct's and the star route's caches; `sql/fused_agg.py`,
`sql/fused_star.py`).  0 where no lookup ran."""
from cachebench.spans import layer_spans_recorded


def read(run):
    if not layer_spans_recorded(run):
        return None
    lookups = sum(s.name == "fused.lookup" for s in run.spans)
    plans = sum(s.name == "fused.plan" for s in run.spans)
    return 100.0 * plans / lookups if lookups else 0.0
