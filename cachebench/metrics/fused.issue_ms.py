"""fused.issue_ms (ms per query): the host time spent enqueuing the fused
routes' planned device programs, one PyTorch call at a time -- the
`fused.issue` spans less the `wait.*` spans they hold -- over the
queries completed."""
from cachebench.spans import per_query_ms


def read(run):
    return per_query_ms(run, lambda s: s.name == "fused.issue")
