"""sql.card_wait_ms (ms per query): the host's waits for the card as the
program names them -- the union of its `wait.*` spans (each
device-to-host fetch, `liquid_tpu_torch.utils.tracing.to_host`, and each
upload from pageable memory on the fused and classic routes, `to_device`,
which waits for the card's stream to drain) -- over the queries
completed.  Blocking runtime calls that no such span holds (the cache
layer's uploads, synchronizes inside PyTorch operators) are not in it."""
from cachebench.spans import layer_spans_recorded
from cachebench.trace import union


def read(run):
    if not layer_spans_recorded(run):
        return None
    waits = union((s.start, s.end) for s in run.spans
                  if s.name.startswith("wait."))
    return sum(e - b for b, e in waits) / 1e6 / run.completed
