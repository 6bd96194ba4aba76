#!/usr/bin/env python
"""Direct cache API: insert, flush to disk, read back.

Port of `examples/example_inprocess_read.py`.
Usage: python examples/torch/example_inprocess_read.py [--device cuda]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import pyarrow as pa  # noqa: E402

from liquid_tpu_torch.cache import LiquidCacheBuilder  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        storage = (LiquidCacheBuilder()
                   .with_disk_path(os.path.join(d, "store.bin"))
                   .with_device(args.device)
                   .build())
        entry_id = 7
        arr = pa.array(range(16), pa.uint64())
        storage.insert(entry_id, arr)

        # move the entry to disk so the read goes through the disk tier
        storage.flush_all_to_disk()
        assert storage.entry_state(entry_id).startswith("disk")

        retrieved = storage.get(entry_id)
        assert retrieved.to_pylist() == arr.to_pylist()
        stats = storage.stats()
        print("read-after-flush OK:", stats["disk_reads"], "disk reads")
        return stats


if __name__ == "__main__":
    main()
