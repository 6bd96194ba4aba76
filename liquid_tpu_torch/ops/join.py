"""Device equi-join pieces: sort-merge build and probe on int64 key codes
(port of `liquid_tpu/ops/join.py`).

1. `sort_build`: a stable sort of the build keys with the row
   permutation.
2. `probe_bounds`: per probe row, the [lo, hi) range of equal build keys
   (two `searchsorted`).
3. `expand_matches`: the variable fan-out ranges flattened into (probe
   row, build position) pairs by prefix-sum index math, into a capacity
   the host sizes from the total.
4. `matched_flags`: which build positions any probe range covers (right
   and full outer joins), from a +1 / -1 difference array and a cumsum.

The reference runs these as XLA ops; here they are the matching torch
calls on whatever device the keys lie on.  The SQL layer
(`sql/device_join.py`) encodes key tuples to int64 codes and takes the
rows on the host.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sort_build(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, int32 permutation): a stable sort with row indices."""
    skeys, perm = torch.sort(keys, stable=True)
    return skeys, perm.to(torch.int32)


def probe_bounds(sorted_keys: torch.Tensor, probe: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per probe key: int32 [lo, hi) bounds of equal keys in the sorted
    build."""
    lo = torch.searchsorted(sorted_keys, probe, side="left")
    hi = torch.searchsorted(sorted_keys, probe, side="right")
    return lo.to(torch.int32), hi.to(torch.int32)


def expand_matches(lo: torch.Tensor, counts: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-probe match ranges flattened into (probe row, build position,
    valid) int32 / int32 / bool [capacity]; `capacity` >= the total of
    `counts`, and positions past the total are invalid."""
    n = lo.shape[0]
    ends = torch.cumsum(counts.to(torch.int64), 0)
    out_pos = torch.arange(capacity, dtype=torch.int64, device=lo.device)
    probe_of = torch.searchsorted(ends, out_pos, side="right")
    pclip = probe_of.clamp(0, n - 1)
    starts = ends - counts.to(torch.int64)
    build_pos = lo.to(torch.int64)[pclip] + (out_pos - starts[pclip])
    valid = out_pos < ends[n - 1]
    return pclip.to(torch.int32), build_pos.to(torch.int32), valid


def matched_flags(sorted_keys: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor) -> torch.Tensor:
    """bool per sorted build position: covered by any probe range."""
    n = sorted_keys.shape[0]
    ones = torch.ones(lo.shape[0], dtype=torch.int32, device=lo.device)
    diff = torch.zeros(n + 1, dtype=torch.int32, device=lo.device)
    diff.index_add_(0, lo.to(torch.int64), ones)
    diff.index_add_(0, hi.to(torch.int64), -ones)
    return torch.cumsum(diff[:n], 0) > 0
