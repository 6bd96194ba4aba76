#!/usr/bin/env python
"""Projection and selection pushdown: only the queried columns enter the
cache, and the predicate is evaluated on the encoded data on the card.

Port of `examples/example_projection_pushdown.py`.
Usage: python examples/torch/example_projection_pushdown.py [--device cuda]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402

QUERY = ('SELECT "RegionID", COUNT(*) AS c FROM hits '
         'WHERE "AdvEngineID" <> 0 '
         'GROUP BY "RegionID" ORDER BY c DESC LIMIT 5')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        ctx, cache = (LiquidCacheLocalBuilder(device=args.device)
                      .with_max_memory_bytes(1 << 30)
                      .with_cache_dir(d)
                      .build())
        ctx.register_parquet("hits", NANO_HITS)
        out = ctx.sql(QUERY)
        out.show()
        st = cache.stats()
        # only the two referenced columns were inserted (x #batches)
        print("cached entries:", st["entries"],
              "encoded predicate evals:", st["predicate_evals_on_encoded"])
        return out.to_arrow(), st


if __name__ == "__main__":
    main()
