#!/usr/bin/env python
"""Compute-node client: ship a query to the cache server and stream the
result back.  Without `--port` it starts a server in this process, on the
card (`--device cpu` for the CPU).

Port of `examples/example_client.py`.
Usage: python examples/torch/example_client.py [--host H --port P]
           [--device cuda]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from liquid_tpu_torch.bench.hits import NANO_HITS  # noqa: E402
from liquid_tpu_torch.server import LiquidCacheClientBuilder  # noqa: E402

QUERY = 'SELECT COUNT(*) AS c, COUNT(DISTINCT "UserID") AS u FROM hits'


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="the device of the in-process server")
    args = p.parse_args(argv)

    srv = admin = None
    with tempfile.TemporaryDirectory() as d:
        if args.port is None:
            from liquid_tpu_torch.bench.clients import serve
            srv, admin = serve(port=0, admin_port=0, block=False,
                               disk_cache_dir=d, device=args.device)
            host, port = srv.addr
        else:
            host, port = args.host or "127.0.0.1", args.port
        try:
            client = (LiquidCacheClientBuilder(host, port)
                      .with_parquet_table("hits", NANO_HITS)
                      .build())
            out = client.sql(QUERY)
            print(out)
            m = client.last_metrics
            print(f"{m.rows} rows in {m.batches} batches, "
                  f"first batch after {m.time_to_first_batch_ms:.1f} ms")
        finally:
            if srv is not None:
                srv.stop()
                admin.stop()
    return out


if __name__ == "__main__":
    main()
