"""fused.plan_ms (ms per query): the host time of planning the fused
routes' device programs on a plan-cache miss -- the `fused.plan` spans
(the planner, dimension and existence builds, the uniqueness fetch) less
the `wait.*` spans they hold -- over the queries completed."""
from cachebench.spans import per_query_ms


def read(run):
    return per_query_ms(run, lambda s: s.name == "fused.plan")
