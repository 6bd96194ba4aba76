#!/usr/bin/env python
"""Direct cache API under a small budget: the replacement loop decides
where an entry lives (memory, squeezed, disk).

Port of `examples/example_inprocess_insertion.py`.
Usage: python examples/torch/example_inprocess_insertion.py [--device cuda]
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
        storage.insert(42, arr)
        got = storage.get(42)
        assert got.to_pylist() == arr.to_pylist()
        state = storage.entry_state(42)
        print("state:", state)
        print(storage.stats())
        return state


if __name__ == "__main__":
    main()
