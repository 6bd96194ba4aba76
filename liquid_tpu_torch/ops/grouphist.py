"""Grouped exact integer sums: the planner's gates and K2's plain version
(port of `liquid_tpu/ops/grouphist_pallas.py:54-126`).

The TPU kernel accumulates i32 payload columns into VMEM tables that
rotate across rows (`ntab`) and flush to HBM every `seg` tiles, so the
planner must prove that no i32 window overflows (`plan_segments`) or
split wide values into hi/lo halves (`plan_hilo`, `split_hilo`).  The
Hopper kernel (`grouphist_cuda.group_accumulate`) adds into exact i64
tables in shared memory and needs neither cadence, but the planner still
computes both: they decide whether a query takes the K2 route at all, so
the port routes exactly the queries the reference does.  The hi/lo split
stays in the contract, so the kernel reads 4 bytes per value.
"""
from __future__ import annotations

from typing import Sequence

import torch

#: rows per TPU grid tile (the reference's n % TILE == 0 contract)
TILE = 1 << 11
#: max slot rows, trash row included
MAX_SLOTS = 64 * 1024
#: max payload columns per call
MAX_COLS = 16
#: max output segments of the TPU kernel (a gate only in the port)
MAX_SEGS = 512
#: hi/lo split point for wide values (lo in [0, 2^SPLIT))
SPLIT = 15


def plan_tables(m: int) -> int:
    """The TPU kernel's accumulator-table count by VMEM footprint; 0 when
    the table does not fit (the reference then keeps the scatter path)."""
    mp = ((m + 1 + 7) // 8) * 8
    per = mp * 128 * 4
    if 9 * per <= 88 * 1024 * 1024:
        return 8
    if 5 * per <= 88 * 1024 * 1024:
        return 4
    if 3 * per <= 100 * 1024 * 1024:
        return 2
    return 0


def plan_segments(n_rows: int, max_abs: int):
    """-> (n_tiles, seg), or None when the bounds defeat the i32 window."""
    if n_rows % TILE != 0:
        return None
    n_tiles = n_rows // TILE
    per_tile = max(int(max_abs), 1) * TILE
    if per_tile > (1 << 30):
        return None  # even one tile can overflow the i32 window
    seg = max(1, (1 << 30) // per_tile)
    nseg = -(-n_tiles // seg)
    if nseg > MAX_SEGS:
        return None
    return n_tiles, seg


def plan_hilo(n_rows: int, max_abs: int):
    """-> (seg, split): split 0 = a plain narrow column, split SPLIT = the
    column rides as (hi, lo) halves; None when even the split can't fit."""
    direct = plan_segments(n_rows, max_abs)
    if direct is not None:
        return direct[1], 0
    hi_abs = (int(max_abs) >> SPLIT) + 1
    sp = plan_segments(n_rows, hi_abs)
    if sp is None:
        return None
    seg_lo = max(1, (1 << 30) // ((1 << SPLIT) * TILE))
    seg = min(sp[1], seg_lo)
    if -(-(n_rows // TILE) // seg) > MAX_SEGS:
        return None
    return seg, SPLIT


def split_hilo(v: torch.Tensor):
    """int64 v -> (hi, lo) int32 with v == hi * 2^SPLIT + lo and lo in
    [0, 2^SPLIT).  `>>` on a signed tensor is arithmetic, so negatives
    stay exact."""
    lo = (v & ((1 << SPLIT) - 1)).to(torch.int32)
    hi = (v >> SPLIT).to(torch.int32)
    return hi, lo


def padded_slots(m: int) -> int:
    """The TPU table's sublane-rounded row count: slots clip to mp - 1."""
    return ((m + 1 + 7) // 8) * 8


def clamp_slots(slot: torch.Tensor, m: int) -> torch.Tensor:
    """The reference's slot clamp: a negative slot goes to the trash row
    m, every slot is clipped to [0, mp - 1]; rows that land in
    (m, mp - 1] are dropped by the caller."""
    slot = torch.where(slot < 0, torch.full_like(slot, m), slot)
    return slot.clamp(0, padded_slots(m) - 1)


def group_accumulate_ref(slot: torch.Tensor, cols: Sequence[torch.Tensor],
                         m: int) -> torch.Tensor:
    """Plain PyTorch version of K2: slot int32[n] and C payload columns
    int32[n] -> exact int64[m + 1, C] per-slot sums (row m collects the
    trash).  It stacks the columns, as the kernel does not."""
    vals = torch.stack([c.to(torch.int64) for c in cols], dim=1)
    s = clamp_slots(slot, m).to(torch.int64)
    out = torch.zeros((padded_slots(m), vals.shape[1]), dtype=torch.int64,
                      device=vals.device)
    out.index_add_(0, s, vals)
    return out[: m + 1]
