#!/usr/bin/env python
"""Open-ended differential fuzz loop for the port's encoded compares.

Random seeds until the time is up, each one string case and one integer
case of `liquid_tpu_torch.bench.fuzz` (byte-view and bit-plane compares
against pyarrow); it stops at the first divergence and prints the seed.
Runs on the card unless `--cpu` is given.

Usage: python fuzz/fuzz_byteview_torch.py [--minutes 5]
           [--start-seed 1000000] [--cpu]
Reproduce: python -c "from liquid_tpu_torch.bench.fuzz import check_case;
           check_case(SEED, 'cuda')"
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--minutes", type=float, default=5.0)
    p.add_argument("--start-seed", type=int, default=1_000_000)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    from liquid_tpu_torch.bench.fuzz import check_case, check_primitive_case
    from liquid_tpu_torch.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    deadline = time.time() + args.minutes * 60
    seed = args.start_seed
    n = 0
    while time.time() < deadline:
        try:
            check_case(seed, device)
            check_primitive_case(seed, device)
        except AssertionError as ex:
            print(f"DIVERGENCE at seed {seed}: {ex}")
            return 1
        seed += 1
        n += 1
        if n % 50 == 0:
            print(f"{n} cases OK (seed {seed})", flush=True)
    print(f"done: {n} cases, no divergence")
    return 0


if __name__ == "__main__":
    sys.exit(main())
