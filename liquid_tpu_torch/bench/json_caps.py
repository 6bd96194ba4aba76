"""JSONBench under memory caps: how many warm block reads the shredded
variant tier serves at each cap.

    python3 -m liquid_tpu_torch.bench.json_caps --events 200000 \\
        --fractions 0.5 0.75 1 1.25 1.5 2 3 5 10 20 40 [--device cpu]

The events come from `json_bench.generate` (seed 8), written once into
`--data-dir` (a temporary directory by default).  For each fraction of
the event column's arrow bytes, a fresh session capped there with the
default squeeze policy runs the five queries once (first runs) and once
more (warm runs).  One JSON line per cap: the blocks, the first runs'
squeezes, the warm runs' disk reads, squeeze IO reads and reads served
from resident shredded paths (`squeeze_io_saved`), and the entry states
at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import pyarrow.parquet as pq

from liquid_tpu_torch import LiquidCacheLocalBuilder
from liquid_tpu_torch.arrays.base import BLOCK_ROWS
from liquid_tpu_torch.bench import json_bench

WARM = ("squeezes", "disk_reads", "squeeze_io_reads", "squeeze_io_saved",
        "hydrations")


def sweep(path: str, fractions, device=None, cache_root=None):
    """One dict per fraction of the file's event column bytes."""
    events = pq.read_table(path)
    col_bytes = events.column("event").nbytes
    blocks = -(-events.num_rows // BLOCK_ROWS)
    del events
    for frac in fractions:
        cap = int(col_bytes * frac)
        with tempfile.TemporaryDirectory(dir=cache_root) as d:
            ctx, cache = (LiquidCacheLocalBuilder(device=device)
                          .with_max_memory_bytes(cap).with_cache_dir(d)
                          .build())
            ctx.register_parquet("events", path)
            for sql in json_bench.QUERIES:
                ctx.sql(sql).to_arrow()
            first = cache.stats()
            for sql in json_bench.QUERIES:
                ctx.sql(sql).to_arrow()
            last = cache.stats()
            yield dict(fraction=frac, cap=cap, column_bytes=col_bytes,
                       blocks=blocks, first_squeezes=first["squeezes"],
                       warm={k: last[k] - first[k] for k in WARM},
                       by_state=last["by_state"],
                       memory_used=last["memory_used"])
            del ctx, cache


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--events", type=int, default=200_000)
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0, 5.0,
                             10.0, 20.0, 40.0])
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_dir or tmp
        path = os.path.join(data_dir, f"json_caps_events_{args.events}"
                            ".parquet")
        if not os.path.exists(path):
            pq.write_table(json_bench.generate(args.events), path)
        for row in sweep(path, args.fractions, args.device, tmp):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
