#!/usr/bin/env python
"""Fill a 1MB cache until the squeeze / evict pipeline engages, and show
how many entries are in each state.

Port of `examples/example_inprocess_cache_eviction.py`.
Usage: python examples/torch/example_inprocess_cache_eviction.py
           [--device cuda]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402

from liquid_tpu_torch.cache import LiquidCacheBuilder  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        storage = (LiquidCacheBuilder()
                   .with_max_memory_bytes(1 << 20)  # 1MB
                   .with_disk_path(os.path.join(d, "store.bin"))
                   .with_device(args.device)
                   .build())
        arr = pa.array(np.arange(1000, dtype=np.uint64))
        for i in range(1, 725):
            storage.insert(i, arr)
        st = storage.stats()
        print("entries:", st["entries"], "by_state:", st["by_state"])
        print("squeezes:", st["squeezes"], "disk_writes:", st["disk_writes"])
        # every surviving entry still reads back exactly
        got = storage.get(1)
        assert got is None or got.to_pylist() == arr.to_pylist()
        return st


if __name__ == "__main__":
    main()
