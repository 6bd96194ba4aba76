#!/usr/bin/env python
"""Local (in-process) mode: register a parquet file and run SQL on the
card (`--device cpu` for the CPU).

Port of `examples/example_local.py`.
Usage: python examples/torch/example_local.py [--device cuda]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.cache import (LiquidPolicy,  # noqa: E402
                                    TranscodeSqueezeEvict)
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        ctx, _cache = (LiquidCacheLocalBuilder(device=args.device)
                       .with_max_memory_bytes(1 << 30)
                       .with_cache_dir(d)
                       .with_squeeze_policy(TranscodeSqueezeEvict())
                       .with_cache_policy(LiquidPolicy())
                       .build())
        ctx.register_parquet("hits", NANO_HITS)
        out = ctx.sql("SELECT COUNT(*) FROM hits")
        out.show()
        return out.to_arrow()


if __name__ == "__main__":
    main()
