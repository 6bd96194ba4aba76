#!/usr/bin/env python
"""Start a cache server and its admin server on the card (`--device cpu`
for the CPU); it serves until `/shutdown` or Ctrl-C.

Port of `examples/example_server.py`.
Usage: python examples/torch/example_server.py [--port 50051]
           [--admin-port 8080] [--max-memory-mb 1024] [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from liquid_tpu_torch.bench.clients import serve  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--admin-port", type=int, default=8080)
    p.add_argument("--max-memory-mb", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    serve(cache_mode="liquid", max_memory_mb=args.max_memory_mb,
          port=args.port, admin_port=args.admin_port, device=args.device)


if __name__ == "__main__":
    main()
