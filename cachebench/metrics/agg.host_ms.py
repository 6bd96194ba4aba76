"""agg.host_ms (ms per query): the classic path's group-by on the host --
the outermost `agg.*` spans (`agg.update`: evaluating the inputs,
encoding the keys and buffering them; `agg.reduce`: the device
reduction's set-up and fetch; `agg.finalize`: decoding the groups into
Arrow) less the `wait.*` spans they hold -- over the queries completed."""
from cachebench.spans import per_query_ms


def read(run):
    return per_query_ms(run, lambda s: s.name.startswith("agg."))
