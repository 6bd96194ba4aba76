"""Time K1's interval form in two thread layouts on one CUDA card.

    python3 -m liquid_tpu_torch.bench.k1_layouts

- "word": the layout the port ships (`ops/csrc/cmp_const_many.cu`, via
  `bitpack_cuda.in_interval_many`): one 4-byte word per thread, one
  8192-row block per 256-thread CTA;
- "x4": `k1_interval_x4.cu` beside this script: four words per thread
  (16-byte loads), four blocks per 256-thread CTA.

At each [B, w, 256] shape of the main path (random planes and bounds
from a seed; K1's time does not depend on the values) both are checked
bit-exact against `in_interval_many_ref`, then timed cold as
`chip_smoke.py` times K1: median of one call with the L2 flushed (a 256
MB write) and a device-side wait before each.  Each layout is timed
twice, in the order word, x4, x4, word.  Prints the card's `nvidia-smi`
name and power limit, then one JSON line per shape.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from liquid_tpu_torch.ops import bitpack_cuda as k1
from liquid_tpu_torch.ops import nvcc

X4_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "k1_interval_x4.cu")
#: (B, w): cb_filter's AdvEngineID, TPC-H lineitem's narrow columns and
#: l_shipdate (the main path's largest K1 input), and one wider input
SHAPES = [(489, 4), (733, 4), (733, 6), (733, 12), (4097, 32)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 700 W


def time_cold(fn, flush: torch.Tensor, iters: int) -> float:
    """Median ms of one call, L2 flushed and a device-side wait of about
    0.5 ms before each."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_layouts: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = nvcc.build_many([k1.SOURCE, X4_SOURCE], verbose=True)
    x4 = ctypes.CDLL(libs[X4_SOURCE]).in_interval_x4_launch
    x4.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    x4.restype = ctypes.c_int
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    for bsz, width in SHAPES:
        planes = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (bsz, width, 256), dtype=np.int64
        ).astype(np.int32)).to(dev)
        lo, hi = (torch.from_numpy(np.sort(rng.integers(
            0, 1 << width, (2, bsz), dtype=np.uint64), axis=0)[i]
            .view(np.int64)).to(dev) for i in (0, 1))
        mask = torch.empty((bsz, 256), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def word():
            return k1.in_interval_many(planes, lo, hi)

        def wide():
            rc = x4(planes.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                    mask.data_ptr(), bsz, width, stream)
            if rc:
                raise RuntimeError(f"x4 launch failed: CUDA error {rc}")
            return mask

        ref = k1.in_interval_many_ref(planes, lo, hi)
        for name, fn in (("word", word), ("x4", wide)):
            if not torch.equal(fn(), ref):
                raise AssertionError(f"{name} != plain at [{bsz}, {width}]")
        ms = {"word": [], "x4": []}
        for name, fn in (("word", word), ("x4", wide), ("x4", wide),
                         ("word", word)):
            ms[name].append(time_cold(fn, flush, 200))
        nbytes = bsz * width * 1024 + 16 * bsz + bsz * 1024
        print(json.dumps({
            "B": bsz, "w": width, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "word_ms": ms["word"], "x4_ms": ms["x4"],
            "x4_over_word": min(ms["x4"]) / min(ms["word"]),
            "matches_plain": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
